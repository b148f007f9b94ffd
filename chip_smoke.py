#!/usr/bin/env python3
"""On-card smoke test: the trainer and renderer, end to end, on an NVIDIA GPU.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --chips 4    # four cards: only sharded training and
                                      # its agreement with one device

Phases on one card, in order; any failure exits non-zero:

1. device      — JAX must report a GPU (it falls back to the CPU silently
                 when its CUDA plugin fails to start); prints the card.
2. flagship    — ``train --preset lego_hierarchical`` at full width (8x256
                 coarse and fine MLPs, 64+128 samples, 4096 rays) on the
                 400^2 hard scene: held-out render, PSNR/SSIM, checkpoint,
                 orbit video; then the train step's compile time and rate.
3. resume      — the same command with more iterations (and no second
                 orbit video) resumes from the saved step;
                 ``render --render-test`` restores and renders.
4. families    — a few steps of lego_ingp, lego_cp, lego_occ and ``image``.
5. agreement   — one train step's loss and parameter gradients and one eval
                 ``render_rays`` (lego_hierarchical, lego_ingp; full width,
                 256 rays) on the GPU against the CPU in float32, as
                 relative L2 errors: at matmul precision "highest" within
                 HIGHEST_TOL, at the default precision (TF32 dots) within
                 DEFAULT_TOL.

With ``--chips 4`` only the data-parallel path runs: ``train`` sharded over
four cards, and one sharded step against the single-device step.

The last line of stdout is printed only when every phase passed:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Everything runs in this one process (a JAX process reserves most of the
card's memory). Run logs go to ``<repo>/.runs/chip_smoke``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Relative L2 error of the GPU result against the CPU float32 result: for
# the loss, for each eval map, and for the whole gradient (every leaf in one
# vector).
# "highest": both sides compute float32 dots, so only rounding differs. The
# flagship's gradient is sensitive to rounding: its 2^9 frequency band
# multiplies position errors by 512, and on the CPU a 1e-7 relative change
# of the ray origins (about one ulp) moves the whole gradient by 6e-5. The
# bound is five times that.
# Default precision: float32 dots may run as TF32 (10-bit mantissa),
# recorded and bounded here rather than hidden.
# Single leaves are printed but not bounded: at init some gradients nearly
# vanish (norms of 1e-9 to 1e-6) and are rounding noise of larger terms.
HIGHEST_TOL = 3e-4
DEFAULT_TOL = 5e-2
# Sharded step against the single-device step (same RNG by construction):
# the loss to float rounding; the gradient within HIGHEST_TOL.
SHARDED_LOSS_RTOL = 1e-5

FLAGSHIP = [
    "train", "--preset", "lego_hierarchical", "--synth-scene", "hard",
    "--synth-resolution", "400", "--precrop-iters", "10",
]


def phases_for(chips: int) -> list:
    """The phases a run executes, in order."""
    if chips == 4:
        return ["device", "sharded"]
    return ["device", "flagship", "resume", "families", "agreement"]


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--chips", type=int, choices=(1, 4), default=1,
        help="1: every phase on one card; 4: only the sharded path on four",
    )
    return p.parse_args(argv)


class _Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def cli(*argv) -> tuple:
    """Run the package CLI in-process; returns (result, seconds, stdout)."""
    from nerf_meets_mlx_tpu.__main__ import main as cli_main

    print(f"$ python -m nerf_meets_mlx_tpu {' '.join(argv)}", flush=True)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = cli_main(list(argv))
    return out, time.perf_counter() - t0, tee.buf.getvalue()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def finite(*xs) -> bool:
    return all(math.isfinite(float(x)) for x in xs)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r}); "
            "nothing was run"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] jax {jax.__version__}: {devs[0]} ({devs[0].device_kind}), "
          f"{len(devs)} visible", flush=True)
    for line in smi.splitlines():
        print(f"[nvidia-smi] {line}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_flagship(runs: Path) -> None:
    import jax

    import bench
    from nerf_meets_mlx_tpu.engine.checkpoint import latest_step

    d = runs / "flagship"
    out, wall, _ = cli(*FLAGSHIP, "--max-iters", "40", "--log-dir", str(d), "--no-shard")
    check(out["start_step"] == 0 and out["step"] == 40, f"flagship steps: {out}")
    check(finite(out["loss"], out["test_psnr_mean"], out["test_ssim_mean"]),
          f"flagship metrics not finite: {out}")
    check(latest_step(d / "ckpt") == 40, "flagship checkpoint missing")
    check((d / "render_00000040.png").stat().st_size > 0, "held-out render missing")
    check(Path(out["video"]).exists(), f"orbit video missing: {out['video']}")
    print(f"[flagship] test_psnr_mean {out['test_psnr_mean']} "
          f"test_ssim_mean {out['test_ssim_mean']} video {out['video']} "
          f"wall {wall:.1f} s", flush=True)

    # the same train step (4096 rays, full width) timed on its own
    step, state, images, poses, n_rand = bench.make_bench_setup(4096)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    state, aux = step(state, images, poses, key)
    jax.block_until_ready((state, aux))
    first = time.perf_counter() - t0
    for _ in range(3):
        state, aux = step(state, images, poses, key)
    jax.block_until_ready((state, aux))
    n = 30
    t0 = time.perf_counter()
    for _ in range(n):
        state, aux = step(state, images, poses, key)
    jax.block_until_ready((state, aux))
    dt = (time.perf_counter() - t0) / n
    check(finite(aux["loss"]), "timed step loss not finite")
    print(f"[flagship] first step (compile included) {first:.2f} s; steady "
          f"{1 / dt:.2f} steps/s, {n_rand / dt:.0f} rays/s, {dt * 1e3:.2f} ms/step",
          flush=True)


def phase_resume(runs: Path) -> None:
    from nerf_meets_mlx_tpu.engine.checkpoint import latest_step

    d = runs / "flagship"
    # the flagship run already wrote the orbit video; skip its 160 frames here
    out, wall, _ = cli(*FLAGSHIP, "--max-iters", "60", "--log-dir", str(d),
                       "--no-shard", "--no-video")
    check(out["start_step"] == 40, f"did not resume from step 40: {out}")
    check(out["step"] == 60 and latest_step(d / "ckpt") == 60, f"resume: {out}")
    check(finite(out["test_psnr_mean"]), f"resume metrics: {out}")
    print(f"[resume] resumed from step {out['start_step']} to {out['step']}; "
          f"test_psnr_mean {out['test_psnr_mean']} wall {wall:.1f} s", flush=True)

    out, wall, _ = cli("render", "--log-dir", str(d), "--render-test")
    check(out["step"] == 60, f"render restored step {out['step']}, expected 60")
    check(finite(out["test_psnr_mean"], out["test_ssim_mean"]), f"render: {out}")
    print(f"[render] restored step {out['step']}; test_psnr_mean "
          f"{out['test_psnr_mean']} over {len(out['test_psnrs'])} views, "
          f"wall {wall:.1f} s", flush=True)


def phase_families(runs: Path) -> None:
    import numpy as np

    for preset in ("lego_ingp", "lego_cp", "lego_occ"):
        d = runs / preset
        out, wall, _ = cli(
            "train", "--preset", preset, "--synth-scene", "hard",
            "--synth-resolution", "100", "--max-iters", "20",
            "--precrop-iters", "0", "--no-video", "--no-shard", "--log-dir", str(d),
        )
        check(out["step"] == 20 and finite(out["loss"], out["test_psnr_mean"]),
              f"{preset}: {out}")
        if preset == "lego_occ":
            # the grid refreshes at steps 0 and 16 (occ_update_every)
            with np.load(d / "ckpt" / "step_00000020" / "state.npz") as f:
                grid = f[".occ_grid"]
            check(float(np.abs(grid).max()) > 0.0, "occupancy grid never refreshed")
        print(f"[{preset}] loss {out['loss']:.5f} test_psnr_mean "
              f"{out['test_psnr_mean']} wall {wall:.1f} s", flush=True)

    out, wall, _ = cli("image", "--size", "100", "--max-iters", "200",
                       "--log-dir", str(runs / "image"))
    check(out["steps"] == 200 and out["final_psnr"] > 12.0, f"image: {out}")
    print(f"[image] final_psnr {out['final_psnr']} wall {wall:.1f} s", flush=True)


def _agreement_inputs(n_rays: int = 256):
    import numpy as np

    from nerf_meets_mlx_tpu.cameras.pose import pose_spherical
    from nerf_meets_mlx_tpu.cameras.rays import get_rays_for_pixels

    rng = np.random.default_rng(0)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    c2w = pose_spherical(30.0, -30.0, 4.0)[:3, :4].astype(np.float32)
    px = rng.integers(0, W, n_rays)
    py = rng.integers(0, H, n_rays)
    rays_o, rays_d = get_rays_for_pixels(K, c2w, px, py)
    target = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    return np.asarray(rays_o), np.asarray(rays_d), target


def rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_agreement() -> None:
    import jax
    import numpy as np

    from nerf_meets_mlx_tpu.config import PRESETS
    from nerf_meets_mlx_tpu.engine.trainer import nerf_loss_fn
    from nerf_meets_mlx_tpu.models import create_nerf

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    rays_o, rays_d, target = _agreement_inputs()
    failed = []
    for preset in ("lego_hierarchical", "lego_ingp"):
        model = create_nerf(PRESETS[preset]())
        params = model.init(jax.random.PRNGKey(0))
        key = jax.random.PRNGKey(1)

        def compute(p, ro, rd, tgt, k):
            (loss, _), grads = jax.value_and_grad(
                lambda q: nerf_loss_fn(model, q, ro, rd, tgt, k), has_aux=True
            )(p)
            ev = model.render_rays(p, ro, rd, key=None, train=False)
            return {"loss": loss, "grads": grads, "rgb": ev["rgb_map"],
                    "depth": ev["depth_map"], "acc": ev["acc_map"]}

        f = jax.jit(compute)
        args = (params, rays_o, rays_d, target, key)
        ref = jax.device_get(f(*jax.device_put(args, cpu)))
        with jax.default_matmul_precision("highest"):
            hi = jax.device_get(f(*jax.device_put(args, gpu)))
        lo = jax.device_get(f(*jax.device_put(args, gpu)))

        for name, got, tol in (("highest", hi, HIGHEST_TOL), ("default", lo, DEFAULT_TOL)):
            pairs = list(zip(
                jax.tree_util.tree_leaves_with_path(got["grads"]),
                jax.tree_util.tree_leaves(ref["grads"]),
            ))
            flat = [np.concatenate([np.ravel(x) for x in xs]) for xs in zip(
                *((a, b) for (_, a), b in pairs))]
            errs = {
                "loss": rel_l2(got["loss"], ref["loss"]),
                "grads": rel_l2(*flat),
                **{k: rel_l2(got[k], ref[k]) for k in ("rgb", "depth", "acc")},
            }
            leaf_err, leaf = max(
                (rel_l2(a, b), jax.tree_util.keystr(path)) for (path, a), b in pairs
            )
            worst = max(errs.values())
            print(f"[agreement] {preset} precision={name}: max relative L2 error "
                  f"{worst:.3e} (tolerance {tol:.0e}); "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f"; worst single leaf {leaf} {leaf_err:.3e} (not bounded)",
                  flush=True)
            if worst > tol:
                failed.append(f"{preset} at precision {name}: {worst:.3e} > {tol:.0e}")
    check(not failed, "; ".join(failed))


def phase_sharded(runs: Path) -> None:
    import jax
    import numpy as np

    from nerf_meets_mlx_tpu.config import lego_hierarchical
    from nerf_meets_mlx_tpu.datasets import make_synthetic_scene
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.engine.trainer import make_nerf_train_step
    from nerf_meets_mlx_tpu.models import create_nerf
    from nerf_meets_mlx_tpu.parallel import (
        make_mesh, make_sharded_nerf_train_step, replicate_state, replicated,
    )

    n_dev = len(jax.devices())
    check(n_dev >= 4, f"--chips 4 needs four devices, JAX sees {n_dev}")
    out, wall, text = cli(
        "train", "--preset", "lego_hierarchical", "--synth-scene", "hard",
        "--synth-resolution", "100", "--precrop-iters", "10", "--max-iters", "20",
        "--no-video", "--log-dir", str(runs / "sharded"),
    )
    check(f"sharded over {n_dev} devices" in text, "train did not shard")
    check(out["step"] == 20 and finite(out["loss"], out["test_psnr_mean"]),
          f"sharded train: {out}")
    print(f"[sharded] train over {n_dev} devices: loss {out['loss']:.5f} "
          f"test_psnr_mean {out['test_psnr_mean']} wall {wall:.1f} s", flush=True)

    cfg = lego_hierarchical()
    model = create_nerf(cfg)
    ds = make_synthetic_scene(4, 1, 1, 100, scene="hard")
    images = np.asarray(ds.images[ds.i_train])
    poses = np.asarray(ds.poses[ds.i_train, :3, :4])
    key = jax.random.PRNGKey(3)

    def init():  # each step donates its state, so each gets its own
        return create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train)

    def grads_of(state):
        # Adam's first moment after one step is (1 - b1) * gradient: the
        # gradient each step actually computed
        return next(
            s.mu for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")
        )

    # float32 dots on both sides, so that only rounding differs (see
    # HIGHEST_TOL); the train run above used the default precision
    with jax.default_matmul_precision("highest"):
        dev0 = jax.devices()[0]
        single = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        s1, aux1 = single(jax.device_put(init(), dev0), jax.device_put(images, dev0),
                          jax.device_put(poses, dev0), key)
        mesh = make_mesh(4)
        sharded = make_sharded_nerf_train_step(model, ds.H, ds.W, ds.focal, mesh)
        imgs = jax.device_put(images, replicated(mesh))
        check(len(imgs.sharding.device_set) == 4, "images not replicated on the mesh")
        s2, aux2 = sharded(replicate_state(init(), mesh), imgs,
                           jax.device_put(poses, replicated(mesh)), key)

    l1, l2 = float(aux1["loss"]), float(aux2["loss"])
    loss_err = abs(l1 - l2) / abs(l1)
    flat = [
        np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(g)])
        for g in (jax.device_get(grads_of(s2)), jax.device_get(grads_of(s1)))
    ]
    grad_err = rel_l2(*flat)
    param_err = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(s1.params)),
                        jax.tree_util.tree_leaves(jax.device_get(s2.params)))
    )
    print(f"[sharded] one step, 4 devices vs 1 (precision highest): loss {l2:.7f} vs "
          f"{l1:.7f} (relative error {loss_err:.3e}, tolerance {SHARDED_LOSS_RTOL:.0e}); "
          f"gradient relative L2 error {grad_err:.3e} (tolerance {HIGHEST_TOL:.0e}); "
          f"max |parameter difference| after Adam {param_err:.3e} (not bounded: "
          f"gradients near Adam's eps get lr-sized updates that rounding moves)",
          flush=True)
    check(loss_err <= SHARDED_LOSS_RTOL, "sharded loss differs")
    check(grad_err <= HIGHEST_TOL, "sharded gradient differs")


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.chips == 1:
        # one card, even on a machine with more
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # the agreement phase computes its reference on the CPU backend
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from nerf_meets_mlx_tpu.utils.compile_cache import configure_compile_cache

    t_start = time.perf_counter()
    device = phase_device()
    print(f"[smoke] compile cache: {configure_compile_cache()}", flush=True)
    runs = REPO / ".runs" / "chip_smoke"
    shutil.rmtree(runs, ignore_errors=True)
    runs.mkdir(parents=True)

    for name in phases_for(args.chips)[1:]:
        t0 = time.perf_counter()
        print(f"[smoke] phase {name}", flush=True)
        if name == "agreement":
            phase_agreement()
        else:
            globals()[f"phase_{name}"](runs)
        print(f"[smoke] phase {name} passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    count = 4 if args.chips == 4 else device["count"]
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(result_line(device["platform"], device["kind"], count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
