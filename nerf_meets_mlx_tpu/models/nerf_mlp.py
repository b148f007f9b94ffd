"""The NeRF MLP as pure functions over a parameter pytree.

Architecture matches the reference NeRF module
(/root/reference/mlx_nerf/models/NeRF.py:160-242):

* D dense layers of width W on the encoded position, ReLU activations,
  with the encoded input concatenated (input-first) after every layer index
  in ``skips`` (reference hardcodes skip-at-4, NeRF.py:68,219-225);
* view-dependent head: alpha(W->1) + feature(W->W), concat encoded viewdir,
  one W/2 hidden layer, rgb(W/2->3); output is concat([rgb, alpha])
  (NeRF.py:191-195,229-239);
* non-viewdir head: a single output projection (NeRF.py:196-197,241) —
  used by the 2-D image-learning path.

Faithful to the reference, NO activation is applied to rgb or alpha at the
model output — activation policy lives in the compositor
(rendering/volume.py), selected by RenderConfig.compositing.

apply() flattens leading dims into one big [N, C] matmul chain so every
layer is a single GEMM; an optional bfloat16 compute path casts
weights+activations for the matmuls and accumulates in float32
(preferred_element_type).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from nerf_meets_mlx_tpu.config import MLPConfig


def _init_linear(key: jax.Array, fan_in: int, fan_out: int) -> Dict[str, jnp.ndarray]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b — the mlx nn.Linear
    default the reference trains with."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(fan_in)
    return {
        "w": jax.random.uniform(kw, (fan_in, fan_out), jnp.float32, -bound, bound),
        "b": jax.random.uniform(kb, (fan_out,), jnp.float32, -bound, bound),
    }


def _linear(p: Dict[str, jnp.ndarray], x: jnp.ndarray, dtype) -> jnp.ndarray:
    return (
        jnp.dot(x.astype(dtype), p["w"].astype(dtype), preferred_element_type=jnp.float32)
        + p["b"]
    )


def init_nerf_mlp(
    key: jax.Array,
    cfg: MLPConfig,
    in_dim: int,
    in_dim_views: int = 0,
) -> Dict[str, Any]:
    """Initialize the parameter pytree for one NeRF MLP."""
    D, W = cfg.net_depth, cfg.net_width
    keys = iter(jax.random.split(key, D + 4))

    pos_linears = []
    for idx in range(D):
        if idx == 0:
            fan_in = in_dim
        elif (idx - 1) in cfg.skips:
            fan_in = W + in_dim
        else:
            fan_in = W
        pos_linears.append(_init_linear(next(keys), fan_in, W))

    params: Dict[str, Any] = {"pos_linears": pos_linears}
    if cfg.use_viewdirs:
        params["alpha_linear"] = _init_linear(next(keys), W, 1)
        params["feature_linear"] = _init_linear(next(keys), W, W)
        params["dir_linear"] = _init_linear(next(keys), W + in_dim_views, W // 2)
        params["rgb_linear"] = _init_linear(next(keys), W // 2, 3)
    else:
        params["output_linear"] = _init_linear(next(keys), W, cfg.out_channels)
    return params


def nerf_mlp_apply(
    params: Dict[str, Any],
    cfg: MLPConfig,
    x_pos: jnp.ndarray,               # [..., in_dim] encoded positions
    x_dir: Optional[jnp.ndarray] = None,  # [..., in_dim_views] encoded dirs
) -> jnp.ndarray:
    """Evaluate the MLP. Returns raw [..., 4] ([rgb, alpha], un-activated)
    or [..., out_channels] for the non-viewdir head."""
    dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    lead = x_pos.shape[:-1]
    x_pos = x_pos.reshape(-1, x_pos.shape[-1])

    h = x_pos
    for idx, p in enumerate(params["pos_linears"]):
        h = jax.nn.relu(_linear(p, h, dtype))
        if idx in cfg.skips:
            h = jnp.concatenate([x_pos, h], axis=-1)  # input-first (NeRF.py:225)

    if cfg.use_viewdirs:
        assert x_dir is not None, "use_viewdirs=True requires encoded viewdirs"
        x_dir = x_dir.reshape(-1, x_dir.shape[-1])
        alpha = _linear(params["alpha_linear"], h, dtype)
        feature = _linear(params["feature_linear"], h, dtype)
        h = jnp.concatenate([feature, x_dir], axis=-1)
        h = jax.nn.relu(_linear(params["dir_linear"], h, dtype))
        rgb = _linear(params["rgb_linear"], h, dtype)
        out = jnp.concatenate([rgb, alpha], axis=-1)
    else:
        out = _linear(params["output_linear"], h, dtype)

    return out.reshape(*lead, out.shape[-1])
