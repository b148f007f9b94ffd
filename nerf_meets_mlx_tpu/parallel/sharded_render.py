"""Multi-device eval rendering: pixels shard over the mesh's ``data`` axis.

Completes the parallel story for evaluation (training shards in
sharded_train.py): a full frame's rays are generated on-device, split into
contiguous per-device pixel shards with `shard_map`, and each device sweeps
its shard in ``lax.map`` chunks for memory — params stay replicated, no
collectives are needed until the (tiny) output gather at the shard_map
boundary.

The reference has no distributed layer at all (its eval loop is a host-side
python chunk loop, /root/reference/mlx_nerf/rendering/render.py:243-266);
this renders test sets / orbit videos across N devices.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from nerf_meets_mlx_tpu.cameras.rays import get_rays, ndc_rays
from nerf_meets_mlx_tpu.parallel.mesh import shard_map_nocheck


def make_sharded_render_image(
    model,
    mesh: Mesh,
    chunk: Optional[int] = None,
) -> Callable:
    """Build render(params, H, W, K, c2w) -> dict of [H, W, ...] maps,
    sharded over `mesh`. The chunk is the GLOBAL rays-per-sweep-step
    (each device processes chunk / n_devices of it)."""
    cfg = model.cfg
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    has_occ = cfg.render.occupancy

    @functools.partial(jax.jit, static_argnames=("H", "W", "chunk_"))
    def _render(
        params, H: int, W: int, K, c2w, chunk_: int, occ_grid=None
    ) -> Dict[str, jnp.ndarray]:
        rays_o, rays_d = get_rays(H, W, K, c2w)
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        if cfg.render.ndc:
            rays_o, rays_d = ndc_rays(H, W, K[0, 0], 1.0, rays_o, rays_d)

        n = rays_o.shape[0]
        n_pad = (-n) % chunk_
        rays_o = jnp.concatenate([rays_o, jnp.zeros((n_pad, 3), rays_o.dtype)], 0)
        rays_d = jnp.concatenate([rays_d, jnp.ones((n_pad, 3), rays_d.dtype)], 0)
        viewdirs = jnp.concatenate([viewdirs, jnp.ones((n_pad, 3), viewdirs.dtype)], 0)
        occ_arg = occ_grid if has_occ and occ_grid is not None else jnp.zeros((), jnp.float32)
        use_occ = has_occ and occ_grid is not None
        loc_chunk = chunk_ // n_dev

        def device_fn(params, ro, rd, vd, occ):
            """Sweep this device's contiguous pixel shard in lax.map chunks."""

            def body(chunk_rays):
                ro_, rd_, vd_ = chunk_rays
                out = model.render_rays(
                    params, ro_, rd_, key=None, train=False, viewdirs=vd_,
                    occ_grid=occ if use_occ else None,
                )
                return {
                    "rgb_map": out["rgb_map"],
                    "disp_map": out["disp_map"],
                    "acc_map": out["acc_map"],
                    "depth_map": out["depth_map"],
                }

            chunked = jax.lax.map(
                body,
                (
                    ro.reshape(-1, loc_chunk, 3),
                    rd.reshape(-1, loc_chunk, 3),
                    vd.reshape(-1, loc_chunk, 3),
                ),
            )
            return {k: v.reshape(-1, *v.shape[2:]) for k, v in chunked.items()}

        out = shard_map_nocheck(
            device_fn,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), P()),
            out_specs=P(axis),
        )(params, rays_o, rays_d, viewdirs, occ_arg)
        out = {k: v[:n] for k, v in out.items()}
        return {
            "rgb_map": out["rgb_map"].reshape(H, W, 3),
            "disp_map": out["disp_map"].reshape(H, W),
            "acc_map": out["acc_map"].reshape(H, W),
            "depth_map": out["depth_map"].reshape(H, W),
        }

    def render(params, H: int, W: int, K, c2w, occ_grid=None) -> Dict[str, jnp.ndarray]:
        c = chunk or cfg.render.ray_chunk
        c = min(c, H * W)
        c = max(n_dev, c - c % n_dev)  # divisible by the mesh
        with mesh:
            return _render(
                params, H, W,
                jnp.asarray(K, jnp.float32), jnp.asarray(np.asarray(c2w)[:3, :4], jnp.float32),
                chunk_=c, occ_grid=occ_grid,
            )

    return render
