"""Learned occupancy grid: per-ray [near, far] tightening beyond the static
scene AABB.

The reference marches the full [near, far] span on every ray
(/root/reference/mlx_nerf/rendering/render.py:134-140). Round 1 added static
AABB slab tightening (cameras/rays.intersect_aabb). This module adds the
*learned* second stage: a density grid EMA-updated from the network
(Instant-NGP-style) whose per-ray first/last occupied probe further tightens
the marched interval — so the SAME static sample count concentrates on actual
geometry, not just on the scene box.

Design constraints (docs/DESIGN.md "Empty-space skipping"):

* No dynamic sample counts — every array keeps a static shape. Tightening
  re-scales the sampling interval; it never changes array shapes.
* The grid is probed ONCE per ray at `n_probes` fixed positions (default
  64 -> 4096*64 = 262k gathers per step), not per sample, and the same
  tightened interval serves both the coarse and fine passes.
* The grid update is a `lax.cond` branch inside the fused train step (one
  density forward over one jittered point per cell every `occ_update_every`
  steps) — no extra dispatch, no host round-trip.
* Probe spacing can exceed the cell size, so the binary grid is dilated by
  one cell (3^3 max-pool) before probing; misses degrade to the conservative
  fallback (the untightened interval), never to wrong renders: rays with no
  occupied probe keep their full [near, far].
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def init_occupancy_grid(resolution: int) -> jnp.ndarray:
    """Empty float density grid [R, R, R]. Empty + the warmup gate in
    `tighten_near_far` means early training is untouched."""
    return jnp.zeros((resolution, resolution, resolution), jnp.float32)


def _cell_points(key: jax.Array, resolution: int, lo: jnp.ndarray, hi: jnp.ndarray):
    """One uniformly-jittered sample point per grid cell, [R^3, 3]."""
    r = resolution
    ii = jnp.stack(
        jnp.meshgrid(jnp.arange(r), jnp.arange(r), jnp.arange(r), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    u = (ii.astype(jnp.float32) + jax.random.uniform(key, ii.shape)) / r
    return lo + u * (hi - lo)


def update_occupancy_grid(
    model,
    params,
    grid: jnp.ndarray,
    key: jax.Array,
    decay: float = 0.95,
    mesh=None,
) -> jnp.ndarray:
    """EMA-max density update (Instant-NGP occupancy-grid rule):
    grid <- max(grid * decay, sigma(one jittered point per cell)).

    Densities come from the finest network (the one that renders); the raw
    density channel goes through the configured activation so the stored
    values are in the same units the compositor integrates.

    With `mesh`, the R^3 density forward shards over the mesh's first axis
    (each device evaluates its cell slice; the grid itself stays replicated
    via the boundary gather) — cell points are generated once at the global
    shape, so the sharded update equals the replicated one bit-for-bit.
    Falls back to the replicated forward when R^3 doesn't divide the mesh.
    """
    rcfg = model.cfg.render
    assert rcfg.aabb is not None, "occupancy grid requires render.aabb"
    lo = jnp.asarray(rcfg.aabb[:3], jnp.float32)
    hi = jnp.asarray(rcfg.aabb[3:], jnp.float32)
    r = grid.shape[0]

    pts = _cell_points(key, r, lo, hi)[:, None, :]        # [R^3, 1, 3]
    level = "fine" if "fine" in params else "coarse"

    def density(p, pts_local):
        dirs = jnp.zeros((pts_local.shape[0], 3), jnp.float32)  # dirs unused
        return model.query(p, level, pts_local, dirs)[..., 0, 3]

    if mesh is not None and pts.shape[0] % mesh.devices.size == 0:
        from jax.sharding import PartitionSpec as P

        from nerf_meets_mlx_tpu.parallel.mesh import shard_map_nocheck

        axis = mesh.axis_names[0]
        raw_sigma = shard_map_nocheck(
            density, mesh=mesh, in_specs=(P(), P(axis)), out_specs=P(axis)
        )(params, pts)
    else:
        raw_sigma = density(params, pts)                  # [R^3]

    if rcfg.compositing == "reference" or rcfg.density_activation == "relu":
        sigma = jax.nn.relu(raw_sigma)
    else:
        sigma = jax.nn.softplus(raw_sigma)
    return jnp.maximum(grid * decay, sigma.reshape(grid.shape))


def occupancy_binary(grid: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Threshold + 3^3 max-pool dilation -> conservative boolean occupancy.

    Dilation absorbs probe-spacing aliasing (probes can straddle a thin
    occupied cell) and gives the tightened interval a one-cell safety margin.
    """
    occ = grid > threshold
    for axis in range(3):
        # shift +-1 along `axis` with zero fill, OR together
        z = jnp.zeros_like(jnp.take(occ, jnp.arange(1), axis=axis))
        up = jnp.concatenate(
            [jax.lax.slice_in_dim(occ, 1, occ.shape[axis], axis=axis), z], axis=axis
        )
        dn = jnp.concatenate(
            [z, jax.lax.slice_in_dim(occ, 0, occ.shape[axis] - 1, axis=axis)],
            axis=axis,
        )
        occ = occ | up | dn
    return occ


def tighten_near_far(
    grid: jnp.ndarray,
    rays_o: jnp.ndarray,          # [B, 3]
    rays_d: jnp.ndarray,          # [B, 3]
    near: jnp.ndarray,            # [B, 1]
    far: jnp.ndarray,             # [B, 1]
    aabb,                         # (x0, y0, z0, x1, y1, z1)
    threshold: float,
    n_probes: int,
    active=True,                  # bool or traced scalar (warmup gate)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Probe the occupancy grid at `n_probes` points per ray; shrink
    [near, far] to bracket the first/last occupied probe (one probe-spacing
    margin each side). Rays with no occupied probe — and all rays while
    `active` is False — keep their incoming interval."""
    lo = jnp.asarray(aabb[:3], jnp.float32)
    hi = jnp.asarray(aabb[3:], jnp.float32)
    r = grid.shape[0]

    frac = (jnp.arange(n_probes, dtype=jnp.float32) + 0.5) / n_probes
    t = near + (far - near) * frac[None, :]                       # [B, P]
    pts = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]  # [B, P, 3]

    u = (pts - lo) / (hi - lo)
    inside = jnp.all((u >= 0.0) & (u < 1.0), axis=-1)             # [B, P]
    idx = jnp.clip((u * r).astype(jnp.int32), 0, r - 1)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]

    occ_bool = occupancy_binary(grid, threshold).reshape(-1)
    occ = occ_bool[flat] & inside                                 # [B, P] gather

    i = jnp.arange(n_probes, dtype=jnp.int32)
    first = jnp.min(jnp.where(occ, i, n_probes), axis=-1)         # [B]
    last = jnp.max(jnp.where(occ, i, -1), axis=-1)
    any_occ = (last >= 0)[:, None]

    dt = (far - near) / n_probes
    t0 = near + jnp.maximum(first[:, None] - 1, 0) * dt
    t1 = near + jnp.minimum(last[:, None] + 2, n_probes) * dt

    keep = jnp.logical_not(jnp.logical_and(any_occ, active))
    new_near = jnp.where(keep, near, t0)
    new_far = jnp.where(keep, far, t1)
    return new_near, new_far
