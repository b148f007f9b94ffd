"""Volume-rendering compositor (the transmittance scan).

jnp re-implementation of the reference's ``raw2outputs``
(/root/reference/mlx_nerf/rendering/render.py:20-96) with the activation
policy made explicit:

* ``mode="reference"`` reproduces the reference bit-for-bit in exact math:
  - NO sigmoid on rgb (render.py:83 composites raw rgb),
  - alpha = 1 - exp(-relu(delta * sigma)) (render.py:67-69),
  - transmittance = exp(-exclusive_cumsum(delta * sigma)) WITHOUT relu inside
    the cumsum (render.py:71-79) — for sigma >= 0 this equals
    cumprod(1 - alpha), but negative raw densities amplify transmittance,
  - optional Gaussian noise added to raw sigma pre-activation
    (render.py:41-43).

* ``mode="canonical"`` is standard NeRF compositing:
  - rgb = sigmoid(raw rgb), sigma = relu(raw sigma + noise),
  - alpha = 1 - exp(-sigma * delta),
  - transmittance = exclusive cumprod(1 - alpha + 1e-10).

Both share: delta-dists with a 1e10 terminal bin scaled by ||rays_d||
(render.py:46-59), weights = alpha * T, and the rgb/depth/disp/acc
composites with white-background completion rgb += (1 - acc)
(render.py:83-92).

The per-ray sample axis stays on one device: the exclusive scan is a cumsum along
the last axis, which XLA fuses with the surrounding elementwise ops — this is
the "sequence scan" of the workload (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp


def _exclusive_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.zeros_like(x[..., :1]), jnp.cumsum(x[..., :-1], axis=-1)], axis=-1
    )


def raw2outputs(
    raw: jnp.ndarray,        # [B, S, 4] un-activated [rgb, sigma]
    z_vals: jnp.ndarray,     # [B, S]
    rays_d: jnp.ndarray,     # [B, 3] (unnormalized)
    mode: str = "canonical",
    raw_noise_std: float = 0.0,
    noise_key: Optional[jax.Array] = None,
    white_bkgd: bool = False,
    density_activation: str = "softplus",
    noise: Optional[jnp.ndarray] = None,  # pre-drawn unit normals [B, S]
) -> Dict[str, jnp.ndarray]:
    """Composite raw network outputs into rgb/depth/disp/acc maps + weights."""
    raw_rgb = raw[..., :3]    # [B, S, 3]
    raw_sigma = raw[..., 3]   # [B, S]

    if raw_noise_std > 0.0:
        if noise is None:
            assert noise_key is not None, "raw_noise_std > 0 requires a PRNG key"
            noise = jax.random.normal(noise_key, raw_sigma.shape)
        raw_sigma = raw_sigma + noise * raw_noise_std

    # delta distances with the 1e10 terminal bin, scaled by ray length
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = jnp.concatenate(
        [deltas, jnp.full_like(deltas[..., :1], 1e10)], axis=-1
    )
    deltas = deltas * jnp.linalg.norm(rays_d[..., None, :], axis=-1)

    if mode == "reference":
        dd = deltas * raw_sigma
        alphas = 1.0 - jnp.exp(-jax.nn.relu(dd))
        transmittance = jnp.exp(-_exclusive_cumsum(dd))  # NB: no relu (render.py:71-79)
        rgb = raw_rgb
    elif mode == "canonical":
        # softplus keeps d sigma/d raw > 0 everywhere; relu (the
        # original-NeRF activation) can leave the whole field dead if an
        # early update drives every sampled raw density negative
        if density_activation == "softplus":
            sigma = jax.nn.softplus(raw_sigma)
        elif density_activation == "relu":
            sigma = jax.nn.relu(raw_sigma)
        else:
            raise ValueError(f"unknown density_activation: {density_activation}")
        tau = sigma * deltas  # optical depth per bin
        alphas = -jnp.expm1(-tau)
        # exp(-prefix-sum of optical depth) == exclusive cumprod(1 - alpha)
        # for sigma >= 0, in log-free form: no log(1-alpha+eps) guard needed,
        # and the jit-fused gradient stays finite at alpha -> 1
        transmittance = jnp.exp(-_exclusive_cumsum(tau))
        rgb = jax.nn.sigmoid(raw_rgb)
    else:
        raise ValueError(f"unknown compositing mode: {mode}")

    weights = alphas * transmittance  # [B, S]

    rgb_map = jnp.sum(weights[..., None] * rgb, axis=-2)          # [B, 3]
    depth_map = jnp.sum(weights * z_vals, axis=-1)                # [B]
    acc_map = jnp.sum(weights, axis=-1)                           # [B]
    disp_map = 1.0 / jnp.maximum(
        1e-10, depth_map / jnp.maximum(acc_map, 1e-10)
    )

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return {
        "rgb_map": rgb_map,
        "depth_map": depth_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
    }


def maps_from_weights(weights: jnp.ndarray, z_vals: jnp.ndarray):
    """(depth, acc, disp) maps from dense sample weights [B, S] — the same
    reductions raw2outputs performs (render.py:85-92), split out so the
    fused eval kernel (which already composited rgb and returns weights
    dense) can finish the map set in XLA."""
    depth_map = jnp.sum(weights * z_vals, axis=-1)
    acc_map = jnp.sum(weights, axis=-1)
    disp_map = 1.0 / jnp.maximum(
        1e-10, depth_map / jnp.maximum(acc_map, 1e-10)
    )
    return depth_map, acc_map, disp_map
