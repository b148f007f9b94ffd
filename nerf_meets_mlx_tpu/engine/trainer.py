"""Training engine.

The reference's trainer never existed (engine/trainer.py in the reference is
an EMPTY file; its train loops live inline in the entrypoints,
/root/reference/mlx_nerf/entrypoints/__test_nerf.py:200-305 and
__viser_image_learning.py:231-315). This module supplies the real engine,
built around:

* ONE fused jit step per iteration: on-device pixel sampling -> ray
  generation -> coarse fwd -> stop-gradient importance resampling -> fine
  fwd -> joint loss -> grads -> Adam update. The reference needed two
  mx.compile graphs, an uncompiled coarse re-forward, and a torch-CPU
  searchsorted round-trip per step (__test_nerf.py:240-293); here the device
  never talks to the host inside a step.
* Joint loss = MSE(coarse) + MSE(fine) (original-NeRF objective). Because the
  sampler is stop-gradient and the passes use disjoint parameters, the
  coarse network still only receives coarse-loss gradients — matching the
  reference's separate steps while halving dispatch overhead.
* The whole training-image tensor stays device-resident; the host loop only
  feeds PRNG keys and reads scalar metrics.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nerf_meets_mlx_tpu.cameras.rays import get_rays_for_pixels, ndc_rays
from nerf_meets_mlx_tpu.config import ExperimentConfig
from nerf_meets_mlx_tpu.engine.train_state import (
    TrainState,
    create_train_state,
    make_optimizer,
)
from nerf_meets_mlx_tpu.models.factory import NeRFModel
from nerf_meets_mlx_tpu.ops.metrics import mse_to_psnr
from nerf_meets_mlx_tpu.utils.logging import MetricsLogger


# ---------------------------------------------------------------------------
# NeRF (volume) train step
# ---------------------------------------------------------------------------


def sample_train_rays(cfg, step, images, poses, K, H: int, W: int, n_rand: int, key):
    """On-device train-batch construction: pick a random image, sample
    n_rand pixels (central crop during the precrop window,
    config_parser.py:29-30), and generate their rays.

    Shared by the single-device and sharded train steps so their semantics
    stay identical. Returns (rays_o, rays_d, target, render_key)."""
    k_img, k_pix, k_render = jax.random.split(jax.random.fold_in(key, step), 3)
    img_i = jax.random.randint(k_img, (), 0, images.shape[0])
    target_img = images[img_i]
    c2w = poses[img_i]

    if cfg.train.precrop_iters > 0:
        frac = cfg.train.precrop_frac
        in_crop = step < cfg.train.precrop_iters
        h_lo = jnp.where(in_crop, jnp.int32(H * (0.5 - frac / 2)), 0)
        h_hi = jnp.where(in_crop, jnp.int32(H * (0.5 + frac / 2)), H)
        w_lo = jnp.where(in_crop, jnp.int32(W * (0.5 - frac / 2)), 0)
        w_hi = jnp.where(in_crop, jnp.int32(W * (0.5 + frac / 2)), W)
    else:
        h_lo, h_hi, w_lo, w_hi = 0, H, 0, W
    if getattr(cfg.train, "pixel_sampling", "replacement") == "no_replacement":
        # reference parity: np.random.choice(..., replace=False) over the
        # crop window (__test_nerf.py:213-236). The crop bounds are traced,
        # so sample by ranking one uniform score per pixel (scores outside
        # the window pushed past the valid range) and taking the n_rand
        # smallest — a uniform no-replacement draw over the window.
        scores = jax.random.uniform(k_pix, (H * W,))
        ys = jnp.arange(H * W, dtype=jnp.int32) // W
        xs = jnp.arange(H * W, dtype=jnp.int32) % W
        valid = (ys >= h_lo) & (ys < h_hi) & (xs >= w_lo) & (xs < w_hi)
        scores = jnp.where(valid, scores, 2.0)
        _, flat = jax.lax.top_k(-scores, n_rand)
        px, py = flat % W, flat // W
    else:
        # with replacement (~n^2/2HW duplicate pixels per batch — ~50 at the
        # reference's 4096/400^2; harmless for SGD and gather-cheaper)
        kx, ky = jax.random.split(k_pix)
        px = jax.random.randint(kx, (n_rand,), w_lo, w_hi)
        py = jax.random.randint(ky, (n_rand,), h_lo, h_hi)

    rays_o, rays_d = get_rays_for_pixels(K, c2w, px, py)
    target = target_img[py, px]  # [n_rand, 3]
    return rays_o, rays_d, target, k_render


def nerf_loss_fn(
    model: NeRFModel,
    params: Any,
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    target: jnp.ndarray,
    key: jax.Array,
    viewdirs: Optional[jnp.ndarray] = None,
    occ_grid: Optional[jnp.ndarray] = None,
    occ_active=True,
    shard_info=None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    out = model.render_rays(
        params, rays_o, rays_d, key, train=True, viewdirs=viewdirs,
        occ_grid=occ_grid, occ_active=occ_active, shard_info=shard_info,
    )
    loss_c = jnp.mean((out["rgb_coarse"] - target) ** 2)
    loss = loss_c
    aux = {"loss_coarse": loss_c}
    if "rgb_fine" in out:
        loss_f = jnp.mean((out["rgb_fine"] - target) ** 2)
        loss = loss_c + loss_f
        aux["loss_fine"] = loss_f
        aux["psnr"] = mse_to_psnr(loss_f)
    else:
        aux["psnr"] = mse_to_psnr(loss_c)
    aux["loss"] = loss
    return loss, aux


def maybe_update_occupancy(
    model: NeRFModel, state: TrainState, key: jax.Array, mesh=None
) -> Tuple[Optional[jnp.ndarray], Any]:
    """Occupancy-grid maintenance inside the train step: every
    occ_update_every steps EMA-update the grid from the current network
    (a lax.cond branch — no separate dispatch), and gate its use on the
    warmup. Returns (occ_grid, occ_active); (None, True) when the feature is
    off. Shared by the single-device and sharded steps; with `mesh` the R^3
    cell forward partitions over the devices instead of replicating."""
    rcfg = model.cfg.render
    if not rcfg.occupancy or state.occ_grid is None:
        return None, True
    from nerf_meets_mlx_tpu.acceleration.occupancy import update_occupancy_grid

    k_occ = jax.random.fold_in(jax.random.fold_in(key, state.step), 0x0CC)
    occ = jax.lax.cond(
        (state.step % rcfg.occ_update_every) == 0,
        lambda g: update_occupancy_grid(
            model, state.params, g, k_occ, rcfg.occ_decay, mesh=mesh
        ),
        lambda g: g,
        state.occ_grid,
    )
    return occ, state.step >= rcfg.occ_warmup


def make_nerf_train_step(
    model: NeRFModel,
    H: int,
    W: int,
    focal: float,
    n_inner: int = 1,
) -> Callable:
    """Build the jitted fused train step.

    step(state, images [N,H,W,3], poses [N,3,4], key) -> (state, metrics).
    Pixel/image selection happens on-device from `key` — the reference's
    host-numpy RNG + gather (__test_nerf.py:200-236) becomes part of the
    compiled program.

    n_inner > 1 wraps the body in a lax.scan so one dispatch advances
    n_inner optimizer steps (amortizing host/dispatch overhead); per-step
    randomness still comes from fold_in(key, state.step). Returned metrics
    are the LAST inner step's.
    """
    cfg = model.cfg
    tx = make_optimizer(cfg.train)
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )

    def body(state: TrainState, images, poses, key):
        rays_o, rays_d, target, k_render = sample_train_rays(
            cfg, state.step, images, poses, K, H, W, cfg.train.n_rand, key
        )
        viewdirs = None
        if cfg.render.ndc:
            # LLFF forward-facing: train in NDC space, but the view head
            # sees pre-NDC world directions (reference: render.py:290-317)
            viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
            rays_o, rays_d = ndc_rays(H, W, float(K[0, 0]), 1.0, rays_o, rays_d)

        occ, occ_active = maybe_update_occupancy(model, state, key)

        def loss_fn(p):
            return nerf_loss_fn(
                model, p, rays_o, rays_d, target, k_render, viewdirs,
                occ_grid=occ, occ_active=occ_active,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            step=state.step + 1, params=params, opt_state=opt_state, occ_grid=occ
        )
        return new_state, aux

    if n_inner <= 1:
        return jax.jit(body, donate_argnums=(0,))

    def multi(state: TrainState, images, poses, key):
        def scan_fn(s, _):
            return body(s, images, poses, key)

        state, auxs = jax.lax.scan(scan_fn, state, None, length=n_inner)
        return state, jax.tree_util.tree_map(lambda a: a[-1], auxs)

    return jax.jit(multi, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# 2-D image-learning train step
# ---------------------------------------------------------------------------


def make_image_train_step(model: NeRFModel) -> Callable:
    """step(state, coords [N,2], colors [N,3], key) -> (state, metrics).

    Each step samples a random pixel batch on-device and regresses rgb
    directly (reference: __viser_image_learning.py:231-279, batch 2500)."""
    cfg = model.cfg
    tx = make_optimizer(cfg.train)
    batch = cfg.train.n_rand

    def step(state: TrainState, coords, colors, key):
        k = jax.random.fold_in(key, state.step)
        idx = jax.random.randint(k, (batch,), 0, coords.shape[0])
        x = coords[idx][:, None, :]   # [B, 1, in_dim] — query's sample axis
        y = colors[idx]

        def loss_fn(p):
            pred = model.query(p, "coarse", x, None)[:, 0, :]
            loss = jnp.mean((pred - y) ** 2)
            return loss, {"loss": loss, "psnr": mse_to_psnr(loss)}

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(step=state.step + 1, params=params, opt_state=opt_state), aux

    return jax.jit(step, donate_argnums=(0,))


# ---------------------------------------------------------------------------
# Host-side orchestration
# ---------------------------------------------------------------------------


class Trainer:
    """Host loop: owns the train state, feeds keys to the fused step,
    handles logging cadence, checkpointing, and periodic eval.

    The engine the reference never built (its engine/trainer.py is empty;
    checkpoint flags existed but saving was `# TODO: load state here`,
    models/NeRF.py:122-125)."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        model: NeRFModel,
        step_fn: Callable,
        step_args: Tuple,
        log_dir: Optional[str | Path] = None,
        steps_per_call: int = 1,
        save_secs: float = 300.0,
        mesh=None,
        main_process: bool = True,
    ):
        self.cfg = cfg
        self.model = model
        self.step_fn = step_fn
        self.step_args = step_args
        self.steps_per_call = steps_per_call
        # wall-clock checkpoint cadence (preemption guard) in addition to
        # the step-count cadence (i_weights); 0 disables
        self.save_secs = save_secs
        # multi-device/multi-host: state replicated on `mesh`; only the main
        # process writes logs/checkpoints (parallel/distributed.py)
        self.mesh = mesh
        self.main_process = main_process
        self._t_saved = time.perf_counter()
        self.key = jax.random.PRNGKey(cfg.train.seed)
        params = model.init(jax.random.fold_in(self.key, 1))
        occ = None
        if cfg.render.occupancy:
            from nerf_meets_mlx_tpu.acceleration.occupancy import init_occupancy_grid

            occ = init_occupancy_grid(cfg.render.occ_resolution)
        self.state = create_train_state(params, cfg.train, occ_grid=occ)
        if mesh is not None:
            from nerf_meets_mlx_tpu.parallel.sharded_train import replicate_state

            self.state = replicate_state(self.state, mesh)
        self.log_dir = Path(log_dir or Path(cfg.train.log_dir) / cfg.train.exp_name)
        self.logger = MetricsLogger(
            self.log_dir / "metrics.jsonl", enabled=main_process
        )
        self._t_last = time.perf_counter()
        self._steps_last = 0
        self._host_step = 0

    @property
    def step(self) -> int:
        # host-side mirror of state.step: reading the device scalar every
        # loop iteration would force a sync per step and serialize dispatch
        # with execution
        return self._host_step

    def device_step(self) -> int:
        """Authoritative step from the device (forces a sync)."""
        return int(self.state.step)

    def restore(self) -> int:
        """Resume from the latest checkpoint in log_dir, if any."""
        from nerf_meets_mlx_tpu.engine.checkpoint import latest_step, restore_checkpoint

        s = latest_step(self.log_dir / "ckpt")
        if s is not None:
            self.state = restore_checkpoint(self.log_dir / "ckpt", self.state, s)
            if self.mesh is not None:
                from nerf_meets_mlx_tpu.parallel.sharded_train import replicate_state

                self.state = replicate_state(self.state, self.mesh)
            else:
                self.state = jax.device_put(self.state)
            self._host_step = int(self.state.step)
        return self.step

    def save(self):
        # Multi-process: the save ends in a barrier every process must enter
        # (engine/checkpoint.py); only process 0 writes. The main_process
        # gate therefore only applies to the single-process case, where it
        # simulates a non-main host.
        if jax.process_count() == 1 and not self.main_process:
            return
        from nerf_meets_mlx_tpu.engine.checkpoint import save_checkpoint

        save_checkpoint(self.log_dir / "ckpt", self.state, self.step)

    def run(
        self,
        n_steps: int,
        log_every: Optional[int] = None,
        sync_every: int = 50,
    ) -> Dict[str, float]:
        """Run n_steps; returns the last metrics dict.

        sync_every bounds dispatch-ahead: the async host loop can otherwise
        enqueue hundreds of steps beyond device execution, which makes
        checkpoint saves (a device_get) stall behind the whole queue —
        observed on slow-step configs where a wall-clock save never landed
        before the job's time budget. One scalar host transfer per
        sync_every steps bounds that queue."""
        log_every = log_every or self.cfg.train.i_print
        metrics = {}
        target = self.step + n_steps
        while self.step < target:
            prev = self.step
            self.state, metrics = self.step_fn(self.state, *self.step_args, self.key)
            self._host_step += self.steps_per_call
            step = self.step
            if sync_every and (step // sync_every) > (prev // sync_every):
                for v in metrics.values():
                    float(v)
                    break
            if log_every and (step // log_every) > (prev // log_every):
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                rate = (step - self._steps_last) / max(now - self._t_last, 1e-9)
                self._t_last, self._steps_last = now, step
                self.logger.log(step=step, steps_per_sec=rate, **metrics)
            if self.cfg.train.i_weights and (step // self.cfg.train.i_weights) > (
                prev // self.cfg.train.i_weights
            ):
                self.save()
                self._t_saved = time.perf_counter()
            elif self.save_secs and time.perf_counter() - self._t_saved > self.save_secs:
                self.save()
                self._t_saved = time.perf_counter()
        return {k: float(v) for k, v in metrics.items()}
