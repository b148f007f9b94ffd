"""NeRF volume-learning entrypoint.

Counterpart of /root/reference/mlx_nerf/entrypoints/__test_nerf.py:25-341,
rebuilt on the engine: fused train step, checkpoint/resume, JSONL metrics,
periodic test-pose renders, and the final orbit video.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import ExperimentConfig, PRESETS, config_from_text
from nerf_meets_mlx_tpu.datasets import load_blender_data, make_synthetic_scene
from nerf_meets_mlx_tpu.engine import Trainer, make_nerf_train_step
from nerf_meets_mlx_tpu.models import create_nerf
from nerf_meets_mlx_tpu.ops import psnr as psnr_fn
from nerf_meets_mlx_tpu.parallel.distributed import init_distributed, is_main_process
from nerf_meets_mlx_tpu.rendering import render_image, render_orbit
from nerf_meets_mlx_tpu.utils.logging import log_devices
from nerf_meets_mlx_tpu.utils.video import write_png, write_video


def _load_dataset(cfg: ExperimentConfig):
    d = cfg.data
    if d.dataset_type == "blender":
        return load_blender_data(
            d.data_dir, half_res=d.half_res, testskip=d.testskip,
            white_bkgd=cfg.render.white_bkgd,
            half_res_filter=d.half_res_filter,
        )
    if d.dataset_type == "llff":
        from nerf_meets_mlx_tpu.datasets.llff import load_llff_data

        return load_llff_data(
            d.data_dir, factor=d.llff_factor, llffhold=d.llffhold,
            spherify=d.spherify,
        )
    if d.dataset_type == "deepvoxels":
        from nerf_meets_mlx_tpu.datasets.deepvoxels import load_deepvoxels_data

        return load_deepvoxels_data(
            d.data_dir, shape=d.dv_shape, testskip=d.testskip
        )
    if d.dataset_type == "synthetic":
        return make_synthetic_scene(
            d.synth_n_train, d.synth_n_val, d.synth_n_test, d.synth_resolution,
            white_bkgd=cfg.render.white_bkgd, scene=d.synth_scene,
        )
    raise ValueError(f"unknown dataset_type for volume training: {d.dataset_type}")


def train_nerf(
    preset: str = "lego_hierarchical",
    data_dir: Optional[str] = None,
    config_txt: Optional[str] = None,
    max_iters: Optional[int] = None,
    log_dir: Optional[str] = None,
    resume: bool = True,
    render_video: bool = True,
    nan_check: bool = False,
    profile_dir: Optional[str] = None,
    synth_resolution: Optional[int] = None,
    synth_scene: Optional[str] = None,
    precrop_iters: Optional[int] = None,
    viewer_port: Optional[int] = None,
    llff_factor: Optional[int] = None,
    spherify: bool = False,
    dv_shape: Optional[str] = None,
    shard: bool = True,
    inner: int = 1,
) -> dict:
    """Train a NeRF; returns final metrics incl. held-out test PSNR.

    nan_check enables jax_debug_nans (the framework's sanitizer mode —
    SURVEY §5); profile_dir captures a jax.profiler device trace of steps
    ~10-20 for TensorBoard. With >1 visible device (several cards, or the
    multi-host path after jax.distributed.initialize) the train step runs
    sharded automatically; shard=False forces single-device."""
    # multi-host: no-op single-process; otherwise every host calls this
    # first so make_mesh() below spans all processes (parallel/distributed.py)
    init_distributed()
    log_devices("train")
    if nan_check:
        jax.config.update("jax_debug_nans", True)
    cfg = PRESETS[preset]()
    if config_txt:
        cfg = config_from_text(config_txt, cfg)
    if data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=data_dir))
    elif cfg.data.dataset_type == "llff":
        # NDC assumes forward-facing captures; the procedural synthetic
        # fallback is a 360 orbit scene and would silently mistrain
        raise ValueError("the llff preset requires --data-dir (a capture with poses_bounds.npy)")
    elif cfg.data.dataset_type == "deepvoxels":
        raise ValueError(
            "the deepvoxels preset requires --data-dir "
            "(the published train/validation/test layout)"
        )
    elif not cfg.data.data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset_type="synthetic"))
    if max_iters:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iters=max_iters))
    if synth_resolution:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, synth_resolution=synth_resolution)
        )
    if synth_scene:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, synth_scene=synth_scene)
        )
    if llff_factor is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, llff_factor=llff_factor))
    if dv_shape is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dv_shape=dv_shape))
    if spherify:
        # NDC linearizes depth for forward-facing frusta only; a 360 capture
        # samples metric space between the capture's depth bounds instead
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, spherify=True),
            render=dataclasses.replace(cfg.render, ndc=False),
        )
    if precrop_iters is not None:
        # NB: a precrop window longer than the run leaves everything outside
        # the central crop untrained (uniform fog) — short runs must shrink it
        cfg = cfg.replace(
            train=dataclasses.replace(cfg.train, precrop_iters=precrop_iters)
        )

    ds = _load_dataset(cfg)
    # non-NDC real captures: sampling bounds come from the capture (LLFF
    # depth bounds / DeepVoxels hemisphere radius), not the config (NDC
    # space keeps the preset's near=0/far=1)
    if not cfg.render.ndc and hasattr(ds, "near"):
        cfg = cfg.replace(
            render=dataclasses.replace(cfg.render, near=ds.near, far=ds.far)
        )
    model = create_nerf(cfg)
    images = np.asarray(ds.images[ds.i_train])
    poses = np.asarray(ds.poses[ds.i_train, :3, :4])

    # multi-device / multi-host: when >1 device is visible the step runs
    # sharded over the data mesh (rays DP, params replicated, grad pmean)
    # with the SAME semantics as the single-device step (shard-invariant
    # RNG, tests/test_parallel.py). --no-shard forces single-device.
    n_dev = len(jax.devices())
    mesh = None
    if shard and n_dev > 1 and cfg.train.n_rand % n_dev == 0:
        from nerf_meets_mlx_tpu.parallel import make_mesh, make_sharded_nerf_train_step

        from nerf_meets_mlx_tpu.parallel import replicated

        mesh = make_mesh(cfg.parallel.n_devices)
        step_fn = make_sharded_nerf_train_step(model, ds.H, ds.W, ds.focal, mesh)
        # replicated on every device of the mesh: left on one device, the
        # whole image set would be copied to the others on every step
        images = jax.device_put(images, replicated(mesh))
        poses = jax.device_put(poses, replicated(mesh))
        print(f"[train] sharded over {mesh.devices.size} devices", flush=True)
        if inner > 1:
            print(
                "[train] --inner is ignored on the sharded path "
                "(step batching is single-device only)", flush=True,
            )
    else:
        # inner > 1 batches steps in a lax.scan so one dispatch advances
        # several optimizer steps — for when per-execution dispatch latency
        # leaves the device idle between steps. Cadences (logging,
        # checkpoint, eval) then quantize to `inner`.
        step_fn = make_nerf_train_step(
            model, ds.H, ds.W, ds.focal, n_inner=max(1, inner)
        )
        images, poses = jax.device_put(images), jax.device_put(poses)
    trainer = Trainer(
        cfg, model, step_fn, (images, poses), log_dir=log_dir,
        steps_per_call=(1 if mesh is not None else max(1, inner)),
        mesh=mesh, main_process=is_main_process(),
    )
    start_step = trainer.restore() if resume else 0
    if start_step:
        print(f"[train] resumed from step {start_step}", flush=True)

    out_dir = trainer.log_dir
    tcfg = cfg.train

    # persist the resolved experiment config (reference: args.txt/config.txt
    # dumps, __test_nerf.py:184-193) — sorted `key = value` flat view plus
    # the full nested config, and a copy of any text-config overlay
    if is_main_process():
        flat = []

        def _walk(prefix, obj):
            for k, v in sorted(dataclasses.asdict(obj).items()) if dataclasses.is_dataclass(obj) else sorted(obj.items()):
                if isinstance(v, dict):
                    _walk(f"{prefix}{k}.", v)
                else:
                    flat.append(f"{prefix}{k} = {v}")

        _walk("", dataclasses.asdict(cfg))
        (out_dir / "args.txt").write_text("\n".join(flat) + "\n")
        if config_txt:
            (out_dir / "config.txt").write_text(Path(config_txt).read_text())

    if profile_dir:
        from nerf_meets_mlx_tpu.utils.profiling import trace

        trainer.run(10)  # warm the compile cache outside the trace
        with trace(profile_dir):
            trainer.run(10)

    # live web viewer for volume training (the reference's viser GUI only
    # served the 2-D image task, __viser_image_learning.py:59-124): pushes a
    # quarter-res held-out render + GT every i_img steps, honors the GUI
    # pause toggle between step chunks
    viewer = None
    view_i = int(ds.i_test[len(ds.i_test) // 2]) if len(ds.i_test) else 0
    if viewer_port is not None:
        from nerf_meets_mlx_tpu.tools.viewer import LiveViewer

        viewer = LiveViewer(port=viewer_port)
        sub = max(1, min(ds.H, ds.W) // 128)
        vH, vW = ds.H // sub, ds.W // sub
        vK = ds.K / sub
        vK[2, 2] = 1.0
        viewer.update("gt", ds.images[view_i][::sub, ::sub])
        print(f"[viewer] http://localhost:{viewer.port}")

    # resuming a finished run skips the loop entirely — keep `metrics` bound
    metrics: dict = {}
    while trainer.step < tcfg.max_iters:
        chunk = tcfg.i_img if viewer else (tcfg.i_testset or tcfg.max_iters)
        n = min(chunk, tcfg.max_iters - trainer.step)
        prev = trainer.step
        metrics = trainer.run(n)
        if viewer is not None:
            out_v = render_image(
                model, trainer.state.params, vH, vW, vK, ds.poses[view_i, :3, :4],
                occ_grid=trainer.state.occ_grid,
            )
            viewer.update("pred", np.asarray(out_v["rgb_map"]))
            viewer.set_state(step=trainer.step, **metrics)
            viewer.wait_if_paused()
        crossed_testset = (tcfg.i_testset or 0) and (
            trainer.step // tcfg.i_testset > prev // tcfg.i_testset
        )
        if not viewer or crossed_testset or trainer.step >= tcfg.max_iters:
            # periodic held-out render (reference: every 50k, __test_nerf.py:308-322)
            test_i = view_i
            out = render_image(
                model, trainer.state.params, ds.H, ds.W, ds.K, ds.poses[test_i, :3, :4],
                occ_grid=trainer.state.occ_grid,
            )
            test_psnr = float(psnr_fn(out["rgb_map"], jnp.asarray(ds.images[test_i])))
            trainer.logger.log(step=trainer.step, test_psnr=test_psnr)
            if is_main_process():
                write_png(out_dir / f"render_{trainer.step:08d}.png", out["rgb_map"])

    trainer.save()
    if viewer is not None:
        viewer.close()

    # final test-set PSNR + SSIM (the reference carries metric classes but
    # never invokes them — SURVEY §6; here every run reports both)
    from nerf_meets_mlx_tpu.ops import ssim as ssim_fn

    psnrs, ssims = [], []
    for i in ds.i_test:
        out = render_image(
            model, trainer.state.params, ds.H, ds.W, ds.K, ds.poses[i, :3, :4],
            occ_grid=trainer.state.occ_grid,
        )
        gt = jnp.asarray(ds.images[i])
        psnrs.append(float(psnr_fn(out["rgb_map"], gt)))
        ssims.append(float(ssim_fn(out["rgb_map"], gt)))
    result = {
        **metrics,
        "start_step": start_step,
        "step": trainer.step,
        "test_psnr_mean": float(np.mean(psnrs)),
        "test_ssim_mean": float(np.mean(ssims)),
    }
    trainer.logger.log(
        step=trainer.step,
        test_psnr_mean=result["test_psnr_mean"],
        test_ssim_mean=result["test_ssim_mean"],
    )

    if render_video and is_main_process():
        frames = render_orbit(
            model, trainer.state.params, ds.H, ds.W, ds.K, ds.render_poses,
            occ_grid=trainer.state.occ_grid,
        )
        result["video"] = str(
            write_video(out_dir / f"orbit_{trainer.step}.avi", frames, fps=30)
        )
    return result
