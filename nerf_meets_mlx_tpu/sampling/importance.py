"""Inverse-CDF (hierarchical importance) sampling — fully on-device.

The reference routes this through a torch-CPU round-trip every iteration
(device→numpy→torch.searchsorted→numpy→device; sampling/__init__.py:101-178,
render.py:214-223, __test_nerf.py:274-285) because mlx lacked searchsorted.
Here it is a pure jnp stage under stop_gradient: the coarse weights feed a
per-ray CDF, and a batched searchsorted runs on the device — no host
boundary, and it fuses into the same jit train step as the coarse forward.

Semantics reproduce the torch variant exactly (the one the reference actually
uses): histogram padding +0.01, eps-renormalization, cdf = min(1, cumsum) with
a prepended 0, right-searchsorted, endpoint-padded z midpoints, guarded
interpolation with nan_to_num + clip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def shard_rand(draw_fn, key, shape, shard_info):
    """Random draw that is invariant to data-parallel sharding.

    With shard_info = (n_global, offset), the draw happens at the GLOBAL
    batch shape and the local shard is sliced out — so the shard_map train
    step (parallel/sharded_train.py) consumes exactly the random stream the
    single-device program would, and sharded == unsharded holds bit-for-bit
    in exact math. The redundant generation costs ~1M threefry lanes per
    device per step — noise. shard_info=None is the single-device fast path.

    Callers must pass draw_fn with any non-default dtype already bound
    (functools.partial) so sharded and single-device branches draw from the
    same stream by construction.
    """
    if shard_info is None:
        return draw_fn(key, shape)
    n_global, offset = shard_info
    full = draw_fn(key, (n_global,) + tuple(shape[1:]))
    return jax.lax.dynamic_slice_in_dim(full, offset, shape[0], 0)


def sample_pdf(
    key: jax.Array | None,
    z_vals,          # [B, n]
    weights,         # [B, n]
    n_importance: int,
    eps: float = 1e-5,
    deterministic: bool = False,
    u=None,          # [B, n_importance] override of the uniform queries
    shard_info=None,  # (n_global, row offset) for shard-invariant draws
):
    """Draw `n_importance` z values per ray from the weights' inverse CDF.

    Matches sample_from_inverse_cdf_torch (sampling/__init__.py:101-178):
    deterministic=True uses stratified linspace(0,1) queries; otherwise
    uniform draws from `key` (or the explicit ``u`` override — used by the
    sharded train step to keep per-device draws identical to the
    single-device program). The entire computation is wrapped in
    stop_gradient — the fine pass must not backprop into the coarse weights
    (the reference detaches via @torch.no_grad()).

    Returns [B, n_importance] (unsorted, like the reference).
    """
    z_vals = jax.lax.stop_gradient(jnp.asarray(z_vals))
    weights = jax.lax.stop_gradient(jnp.asarray(weights))
    B, n = weights.shape

    w = weights + 0.01  # histogram padding
    w_sum = jnp.sum(w, axis=-1, keepdims=True)
    padding = jax.nn.relu(eps - w_sum)
    w = w + padding / n
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = jnp.minimum(1.0, jnp.cumsum(pdf, axis=-1))
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)  # [B, n+1]

    if deterministic:
        u = jnp.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype)
        u = jnp.broadcast_to(u, (B, n_importance))
    elif u is None:
        # dtype bound explicitly so the sharded and single-device branches
        # draw from the same threefry stream by construction (ADVICE r2)
        u = shard_rand(
            functools.partial(jax.random.uniform, dtype=cdf.dtype),
            key, (B, n_importance), shard_info,
        )
    else:
        u = jax.lax.stop_gradient(jnp.asarray(u))

    # Right-searchsorted + the four index gathers, reformulated gather-free
    # as masked reductions: with
    #   C[b, j, k] = (cdf[b, j] <= u[b, k])
    # the torch-variant's below/above lookups become masked reductions over
    # the sorted cdf / midpoint arrays:
    #   x[below] = max_j { x[j] : C }   (C[0] always holds: cdf[0] = 0)
    #   x[above] = min_j { x[j] : !C }, falling back to x[n] when all hold
    # — exactly clip(inds-1, 0, n) / clip(inds, 0, n) indexing for
    # non-decreasing x. Everything is broadcast work that XLA fuses into one
    # pass over the [B, n+1, n_imp] cube.
    C = cdf[:, :, None] <= u[:, None, :]  # [B, n+1, n_imp]

    # endpoint-padded bin midpoints: [m0, m0..m_{n-2}, m_{n-2}] -> [B, n+1]
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])  # [B, n-1]
    z_mid = jnp.concatenate([z_mid[..., :1], z_mid, z_mid[..., -1:]], axis=-1)

    def at_below(x):  # x [B, n+1] non-decreasing -> x[below] [B, n_imp]
        return jnp.max(jnp.where(C, x[:, :, None], -jnp.inf), axis=1)

    def at_above(x):
        masked_min = jnp.min(jnp.where(C, jnp.inf, x[:, :, None]), axis=1)
        return jnp.minimum(masked_min, x[:, -1:])  # all-C rows fall back to x[n]

    cdf_from = at_below(cdf)
    cdf_to = at_above(cdf)
    z_from = at_below(z_mid)
    z_to = at_above(z_mid)

    denom = cdf_to - cdf_from
    denom = jnp.where(denom < eps, jnp.ones_like(denom), denom)
    t = jnp.nan_to_num((u - cdf_from) / denom, nan=0.0)
    t = jnp.clip(t, 0.0, 1.0)
    return z_from + t * (z_to - z_from)


def merge_z(z_vals, z_importance):
    """Sort-merge coarse and importance z values along the sample axis
    (render.py:225, __test_nerf.py:288)."""
    return jnp.sort(jnp.concatenate([z_vals, z_importance], axis=-1), axis=-1)
