"""Multi-device data-parallel training step (shard_map).

Rays shard over the mesh's ``data`` axis; params/optimizer state replicate.
The per-device body is the SAME loss as the single-device path
(engine/trainer.py nerf_loss_fn) wrapped in `shard_map`: each device runs
its local rays and the gradient all-reduce is one explicit `pmean`, which
XLA overlaps with the backward pass.

RNG is shard-invariant: every random draw inside the step happens at the
GLOBAL batch shape with the shared key, and each device slices its shard
(models/factory._shard_rand). Sharded and single-device programs therefore
consume identical random streams, and `sharded step == single-device step`
holds to float tolerance (tests/test_parallel.py). Cost: each device
generates the full batch's random bits redundantly (~1M threefry lanes per
step), bounded by n_rand, not by device count times n_rand.

This replaces nothing in the reference (it has no distributed layer at all,
SURVEY.md §2 checklist).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from nerf_meets_mlx_tpu.engine.train_state import TrainState, make_optimizer
from nerf_meets_mlx_tpu.engine.trainer import (
    maybe_update_occupancy,
    nerf_loss_fn,
    sample_train_rays,
)
from nerf_meets_mlx_tpu.models.factory import NeRFModel
from nerf_meets_mlx_tpu.ops.metrics import mse_to_psnr
from nerf_meets_mlx_tpu.parallel.mesh import replicated, shard_map_nocheck


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place every leaf of the train state replicated on the mesh."""
    return jax.device_put(state, replicated(mesh))


def make_sharded_nerf_train_step(
    model: NeRFModel,
    H: int,
    W: int,
    focal: float,
    mesh: Mesh,
    n_rand_per_device: int = 0,
) -> Callable:
    """Build step(state, images, poses, key) -> (state, metrics) sharded over
    `mesh`. Global ray batch = n_rand_per_device * n_devices (weak scaling)
    or cfg.train.n_rand if n_rand_per_device == 0."""
    cfg = model.cfg
    tx = make_optimizer(cfg.train)
    n_dev = mesh.devices.size
    n_rand = (n_rand_per_device * n_dev) if n_rand_per_device else cfg.train.n_rand
    if n_rand % n_dev:
        raise ValueError(f"global ray batch {n_rand} not divisible by {n_dev} devices")
    local_b = n_rand // n_dev
    axis = mesh.axis_names[0]
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)

    has_occ = cfg.render.occupancy

    def device_fn(params, rays_o, rays_d, target, viewdirs, occ, occ_active, key):
        """Runs on each device with its local ray shard."""
        idx = jax.lax.axis_index(axis)
        shard_info = (n_rand, idx * local_b)

        def loss_fn(p):
            return nerf_loss_fn(
                model, p, rays_o, rays_d, target, key,
                viewdirs=viewdirs if cfg.render.ndc else None,
                occ_grid=occ if has_occ else None,
                occ_active=occ_active,
                shard_info=shard_info,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        # replicated params over sharded rays: one explicit all-reduce,
        # overlapped with the backward by XLA
        grads = jax.lax.pmean(grads, axis)
        aux = jax.lax.pmean(aux, axis)
        return grads, aux

    def step(state: TrainState, images, poses, key):
        rays_o, rays_d, target, k_render = sample_train_rays(
            cfg, state.step, images, poses, K, H, W, n_rand, key
        )
        if cfg.render.ndc:
            # LLFF forward-facing: train in NDC space, but the view head
            # sees pre-NDC world directions (reference: render.py:290-317) —
            # the only case where viewdirs must be computed pre-transform
            # and shipped into the sharded region (ADVICE r2)
            from nerf_meets_mlx_tpu.cameras.rays import ndc_rays

            viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
            vd_spec = P(axis)
            rays_o, rays_d = ndc_rays(H, W, float(K[0, 0]), 1.0, rays_o, rays_d)
        else:
            viewdirs = jnp.zeros((), jnp.float32)  # dummy; model renormalizes
            vd_spec = P()

        # occupancy grid maintenance runs sharded over the cell batch
        # (see maybe_update_occupancy / update_occupancy_grid)
        occ, occ_active = maybe_update_occupancy(model, state, key, mesh=mesh)
        occ_arg = occ if has_occ else jnp.zeros((), jnp.float32)
        occ_act_arg = jnp.asarray(occ_active)

        grads, aux = shard_map_nocheck(
            device_fn,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), vd_spec, P(), P(), P()),
            out_specs=(P(), P()),
        )(state.params, rays_o, rays_d, target, viewdirs, occ_arg, occ_act_arg, k_render)

        # psnr of the mean loss, not the mean of per-device psnrs
        aux["psnr"] = mse_to_psnr(aux.get("loss_fine", aux["loss_coarse"]))

        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            step=state.step + 1, params=params, opt_state=opt_state, occ_grid=occ
        )
        return new_state, aux

    return jax.jit(step, donate_argnums=(0,))
