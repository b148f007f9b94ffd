"""Diagnose the config-4 plateau (VERDICT r4 #6): why does the 800^2 hard
scene flatline at ~31.8 dB from 60k to 200k iters?

Part 1 (this script, eval only): render GT-vs-pred ERROR MAPS from the
200k checkpoint of the durable chain (.runs/config4_long/run) and measure
where the residual error lives. Edge-concentration statistic: fraction of
total squared error inside the GT's high-gradient band (top-decile Sobel
magnitude, dilated 1 px) vs that band's area fraction. A concentration
ratio >> 1 means the residual is edge aliasing — a sampling/band-limit
ceiling of the recipe on this scene — rather than structured low-frequency
error a longer/looser schedule could still remove.

Part 2 (variant leg, run separately):
  python tools_dev/config4_plateau_probe.py --variant lr4 --iters 5000
clones the chain and resumes 5k iters with lrate x4 (overlay) to test the
"lr floor too low" hypothesis; `--variant control` resumes unchanged.

Artifacts: docs/results/config4_errmap_*.png, config4_plateau.json(l).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CHAIN = REPO / ".runs" / "config4_long" / "run"
RESULTS = REPO / "docs" / "results"


def _cfg():
    import dataclasses

    from nerf_meets_mlx_tpu.config import PRESETS

    cfg = PRESETS["lego_full"]()
    return cfg.replace(
        data=dataclasses.replace(
            cfg.data, synth_n_train=50, synth_resolution=800,
            synth_scene="hard",
        ),
    )


def _dataset(cfg):
    from nerf_meets_mlx_tpu.datasets import make_synthetic_scene

    d = cfg.data
    return make_synthetic_scene(
        d.synth_n_train, d.synth_n_val, d.synth_n_test, d.synth_resolution,
        white_bkgd=cfg.render.white_bkgd, scene=d.synth_scene,
    )


def _edge_band(gt: np.ndarray) -> np.ndarray:
    """Top-decile gradient-magnitude mask of the GT, dilated 1 px."""
    g = gt.mean(axis=-1)
    gx = np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
    gy = np.abs(np.diff(g, axis=0, prepend=g[:1]))
    mag = gx + gy
    thr = np.quantile(mag, 0.9)
    band = mag >= thr
    d = band.copy()
    d[1:] |= band[:-1]
    d[:-1] |= band[1:]
    d[:, 1:] |= band[:, :-1]
    d[:, :-1] |= band[:, 1:]
    return d


def error_maps(step: int = 200_000, n_views: int = 3):
    import jax
    import jax.numpy as jnp
    import imageio.v2 as imageio

    from nerf_meets_mlx_tpu.engine.checkpoint import restore_checkpoint
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.models import create_nerf
    from nerf_meets_mlx_tpu.ops.metrics import psnr as psnr_fn
    from nerf_meets_mlx_tpu.rendering import render_image

    cfg = _cfg()
    model = create_nerf(cfg)
    template = create_train_state(
        model.init(jax.random.PRNGKey(0)), cfg.train
    )
    state = restore_checkpoint(CHAIN / "ckpt", template, step)
    assert int(state.step) == step, int(state.step)
    ds = _dataset(cfg)

    rows = []
    for k, i in enumerate(ds.i_test[:n_views]):
        out = render_image(
            model, state.params, ds.H, ds.W, ds.K, ds.poses[i, :3, :4]
        )
        pred = np.asarray(out["rgb_map"])
        gt = ds.images[i]
        err2 = ((pred - gt) ** 2).sum(axis=-1)
        band = _edge_band(gt)
        frac_err_in_band = float(err2[band].sum() / max(err2.sum(), 1e-12))
        area_frac = float(band.mean())
        rows.append({
            "view": int(i),
            "psnr": round(float(psnr_fn(jnp.asarray(pred), jnp.asarray(gt))), 3),
            "err_frac_in_edge_band": round(frac_err_in_band, 4),
            "edge_band_area_frac": round(area_frac, 4),
            "concentration": round(frac_err_in_band / max(area_frac, 1e-9), 2),
            # top-percentile error pixels: how extreme is the tail?
            "err2_p50": float(np.quantile(err2, 0.5)),
            "err2_p99": float(np.quantile(err2, 0.99)),
        })
        em = np.clip(np.sqrt(err2) / 0.25, 0, 1)  # |err| 0..0.25 -> 0..1
        imageio.imwrite(
            RESULTS / f"config4_errmap_{step}_{int(i)}.png",
            (em * 255).astype(np.uint8),
        )
        print("[plateau]", json.dumps(rows[-1]), flush=True)

    artifact = {"step": step, "views": rows}
    (RESULTS / "config4_plateau.json").write_text(json.dumps(artifact, indent=1))
    return artifact


def variant_leg(kind: str, iters: int):
    """Clone the chain, resume `iters` more with a variant overlay."""
    from nerf_meets_mlx_tpu.entrypoints.train_nerf import train_nerf

    src_ckpt = CHAIN / "ckpt" / "step_00200000"
    work = REPO / ".runs" / "config4_long" / f"variant_{kind}"
    ck = work / "ckpt" / "step_00200000"
    if not ck.exists():
        ck.parent.mkdir(parents=True, exist_ok=True)
        shutil.copytree(src_ckpt, ck)
    overlay = work / "overlay.txt"
    lines = ["synth_n_train = 50\n"]
    if kind == "lr4":
        lines.append("lrate = 2e-3\n")  # 4x the preset's 5e-4 at every step
    elif kind != "control":
        raise SystemExit(f"unknown variant {kind}")
    overlay.write_text("".join(lines))

    t0 = time.time()
    m = train_nerf(
        preset="lego_full",
        max_iters=200_000 + iters,
        log_dir=str(work),
        render_video=False,
        synth_resolution=800,
        synth_scene="hard",
        config_txt=str(overlay),
    )
    row = {
        "variant": kind,
        "through_iters": 200_000 + iters,
        "test_psnr_mean": round(float(m.get("test_psnr_mean", -1)), 2),
        "test_ssim_mean": round(float(m.get("test_ssim_mean", -1)), 4),
        "wall_s": round(time.time() - t0, 1),
    }
    with (RESULTS / "config4_plateau.jsonl").open("a") as f:
        f.write(json.dumps(row) + "\n")
    print("[plateau]", json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    if "--variant" in sys.argv:
        kind = sys.argv[sys.argv.index("--variant") + 1]
        iters = (
            int(sys.argv[sys.argv.index("--iters") + 1])
            if "--iters" in sys.argv else 5000
        )
        variant_leg(kind, iters)
    else:
        error_maps()
