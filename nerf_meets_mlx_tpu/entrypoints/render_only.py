"""Render-only entrypoint: load a checkpoint, render test poses or the orbit.

Capability of the reference's --render_only / --render_test flags
(/root/reference/mlx_nerf/config_parser.py:46-47) which its train driver
never implemented (render_poses handling at __test_nerf.py:177-179 is the
closest). Renders from the latest checkpoint in the experiment's log dir.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import PRESETS
from nerf_meets_mlx_tpu.engine.checkpoint import latest_step, restore_checkpoint
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.entrypoints.train_nerf import _load_dataset
from nerf_meets_mlx_tpu.models import create_nerf
from nerf_meets_mlx_tpu.ops import psnr as psnr_fn, ssim as ssim_fn
from nerf_meets_mlx_tpu.rendering import render_image, render_orbit
from nerf_meets_mlx_tpu.utils.logging import log_devices
from nerf_meets_mlx_tpu.utils.video import write_png, write_video


def render_only(
    preset: str = "lego_hierarchical",
    log_dir: str = "",
    data_dir: Optional[str] = None,
    render_test: bool = False,
    out_dir: Optional[str] = None,
    n_orbit: int = 160,
    spherify: bool = False,
    dv_shape: Optional[str] = None,
) -> dict:
    """Render from the latest checkpoint under ``log_dir``.

    render_test=True renders + scores the held-out test views (PSNR);
    otherwise writes the orbit video.
    """
    log_devices("render")
    cfg = PRESETS[preset]()
    if dv_shape is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dv_shape=dv_shape))
    if spherify:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, spherify=True),
            render=dataclasses.replace(cfg.render, ndc=False),
        )
    if data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=data_dir))
    elif not cfg.data.data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset_type="synthetic"))

    ds = _load_dataset(cfg)
    # mirror the training-time bound override (capture-derived near/far) so
    # the rendered sampling span matches what the checkpoint was trained with
    if not cfg.render.ndc and hasattr(ds, "near"):
        cfg = cfg.replace(
            render=dataclasses.replace(cfg.render, near=ds.near, far=ds.far)
        )
    model = create_nerf(cfg)

    ckpt_dir = Path(log_dir) / "ckpt"
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    occ = None
    if cfg.render.occupancy:
        from nerf_meets_mlx_tpu.acceleration.occupancy import init_occupancy_grid

        occ = init_occupancy_grid(cfg.render.occ_resolution)
    template = create_train_state(
        model.init(jax.random.PRNGKey(0)), cfg.train, occ_grid=occ
    )
    state = jax.device_put(restore_checkpoint(ckpt_dir, template, step))
    out_path = Path(out_dir or (Path(log_dir) / f"render_only_{step}"))
    out_path.mkdir(parents=True, exist_ok=True)

    result: dict = {"step": step}
    if render_test:
        psnrs, ssims = [], []
        for i in ds.i_test:
            out = render_image(
                model, state.params, ds.H, ds.W, ds.K, ds.poses[i, :3, :4],
                occ_grid=state.occ_grid,
            )
            gt = jnp.asarray(ds.images[i])
            psnrs.append(float(psnr_fn(out["rgb_map"], gt)))
            ssims.append(float(ssim_fn(out["rgb_map"], gt)))
            write_png(out_path / f"test_{i:03d}.png", out["rgb_map"])
        result["test_psnr_mean"] = float(np.mean(psnrs))
        result["test_ssim_mean"] = float(np.mean(ssims))
        result["test_psnrs"] = psnrs
    else:
        poses = ds.render_poses[:n_orbit]
        frames = render_orbit(
            model, state.params, ds.H, ds.W, ds.K, poses, occ_grid=state.occ_grid
        )
        path = write_video(out_path / "orbit.avi", frames, fps=30)
        result["video"] = str(path)
    return result
