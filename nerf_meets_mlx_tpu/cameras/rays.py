"""Pinhole ray generation and NDC reprojection.

Device-side jnp equivalents of the reference's host-numpy helpers
(/root/reference/mlx_nerf/rendering/ray.py:7-70). Unlike the reference —
which regenerates rays on the host with numpy every train iteration
(__test_nerf.py:208) — these are pure jnp functions, jit-able and shardable,
so ray generation fuses into the train step on-device.

Conventions match NeRF: camera looks down -z, +x right, +y up; pixel (i, j)
maps to direction ((i-cx)/fx, -(j-cy)/fy, -1) in camera space (ray.py:21-27).
"""

from __future__ import annotations

import jax.numpy as jnp


def get_rays(H: int, W: int, K, c2w):
    """Generate world-space rays for every pixel of an HxW pinhole camera.

    Args:
      H, W: static image dims.
      K: [3,3] intrinsics (fx=K[0,0], fy=K[1,1], cx=K[0,2], cy=K[1,2]).
      c2w: [3,4] or [4,4] camera-to-world matrix.

    Returns:
      rays_o, rays_d: each [H, W, 3]. Directions are NOT normalized
      (matching ray.py:29-32 — the norm scales delta_dists in compositing).
    """
    K = jnp.asarray(K, dtype=jnp.float32)
    c2w = jnp.asarray(c2w, dtype=jnp.float32)
    i, j = jnp.meshgrid(
        jnp.arange(W, dtype=jnp.float32),
        jnp.arange(H, dtype=jnp.float32),
        indexing="xy",
    )
    dirs = jnp.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -jnp.ones_like(i)],
        axis=-1,
    )  # [H, W, 3] camera-space
    # rotate into world: sum_k dirs[k] * R[:, k]; tiny 3x3 contraction —
    # force full fp32 (default matmul precision may drop to bf16)
    rays_d = jnp.einsum("hwk,ck->hwc", dirs, c2w[:3, :3], precision="highest")
    rays_o = jnp.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def get_rays_for_pixels(K, c2w, px, py):
    """Rays for a flat list of pixel coordinates (train-time subsampling).

    The reference gathers rays AFTER generating the full HxW grid
    (__test_nerf.py:208-233); generating only the selected pixels' rays
    avoids materializing H*W*6 floats per step.

    Args:
      px, py: [N] pixel x (column) and y (row) coordinates (float or int).

    Returns:
      rays_o, rays_d: each [N, 3].
    """
    K = jnp.asarray(K, dtype=jnp.float32)
    c2w = jnp.asarray(c2w, dtype=jnp.float32)
    px = jnp.asarray(px, dtype=jnp.float32)
    py = jnp.asarray(py, dtype=jnp.float32)
    dirs = jnp.stack(
        [(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -jnp.ones_like(px)],
        axis=-1,
    )  # [N, 3]
    rays_d = jnp.einsum("nk,ck->nc", dirs, c2w[:3, :3], precision="highest")
    rays_o = jnp.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def intersect_aabb(rays_o, rays_d, box_min, box_max, near, far, eps: float = 1e-6):
    """Per-ray slab intersection with a scene AABB: tightened [near, far].

    The static-shape empty-space-skipping primitive: instead of pruning
    samples (dynamic shapes), the SAME static sample count is concentrated
    into the segment of each ray that can contain geometry. Pure elementwise
    math, fuses into the train step. Rays that miss the box keep the original
    [near, far] (they composite to background regardless).

    Args:
      rays_o, rays_d: [B, 3] (directions need not be normalized).
      box_min, box_max: length-3 box corners.
      near, far: scalars or [B, 1] — the untightened bounds.

    Returns:
      near_t, far_t: [B, 1] with near <= near_t <= far_t <= far.
    """
    box_min = jnp.asarray(box_min, jnp.float32)
    box_max = jnp.asarray(box_max, jnp.float32)
    # guard axis-parallel rays: huge inv keeps the slab test correct
    d = jnp.where(jnp.abs(rays_d) < eps, jnp.where(rays_d < 0, -eps, eps), rays_d)
    inv = 1.0 / d
    t0 = (box_min - rays_o) * inv
    t1 = (box_max - rays_o) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1, keepdims=True)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1, keepdims=True)
    near = jnp.broadcast_to(jnp.asarray(near, jnp.float32), tmin.shape)
    far = jnp.broadcast_to(jnp.asarray(far, jnp.float32), tmax.shape)
    hit = tmax > jnp.maximum(tmin, 0.0)
    near_t = jnp.where(hit, jnp.clip(tmin, near, far), near)
    far_t = jnp.where(hit, jnp.clip(tmax, near, far), far)
    return near_t, jnp.maximum(far_t, near_t + eps)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Reproject rays into NDC space (NeRF appendix C, eqs. 25/26).

    Semantics match ray.py:39-70: first shift origins to the z=-near plane,
    then apply the projective map.
    """
    # shift origin to near plane
    t_n = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t_n[..., None] * rays_d

    o_x, o_y, o_z = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    d_x, d_y, d_z = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = (-focal / (0.5 * W)) * (o_x / o_z)
    o1 = (-focal / (0.5 * H)) * (o_y / o_z)
    o2 = 1.0 + 2.0 * near / o_z

    d0 = (-focal / (0.5 * W)) * (d_x / d_z - o_x / o_z)
    d1 = (-focal / (0.5 * H)) * (d_y / d_z - o_y / o_z)
    d2 = -2.0 * near / o_z

    return jnp.stack([o0, o1, o2], axis=-1), jnp.stack([d0, d1, d2], axis=-1)
