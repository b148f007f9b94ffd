"""Keep the real-dataset path warm (VERDICT r4 #8): validate the FULL
`--data-dir` pipeline end-to-end on a synthetic-but-on-disk Blender tree —
transforms_{train,val,test}.json + PNGs written to disk, loaded through the
production Blender loader (native PNG decode, focal from camera_angle_x,
white-bkgd compositing), trained for a few steps with the lego_full
recipe's config-4 preset, eval-rendered, and checkpointed.

The day a real `nerf_synthetic/lego` download lands, the 200k config-4
chain is one command:

    python tools_dev/config4_long_run.py --data-dir /path/to/nerf_synthetic/lego

and this smoke test is the proof the plumbing works before burning a day
of device time. (The reference's loader this mirrors:
/root/reference/mlx_nerf/dataset/dataloader.py:20-92.)

Usage: python tools_dev/real_lego_smoke.py [--res 64] [--iters 10]
Prints one JSON line: {"ok": true, "test_psnr_mean": ..., "ckpt_steps": N}
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def arg(name, default):
    if name in sys.argv:
        return int(sys.argv[sys.argv.index(name) + 1])
    return default


def run_smoke(res: int = 64, iters: int = 10, work_dir: str | None = None):
    from nerf_meets_mlx_tpu.datasets import write_blender_dataset
    from nerf_meets_mlx_tpu.entrypoints.train_nerf import train_nerf

    work = Path(work_dir or tempfile.mkdtemp(prefix="real_lego_smoke_"))
    scene = work / "lego"
    # an on-disk Blender tree of the procedural scene: same format a real
    # nerf_synthetic/lego download has (transforms_*.json + PNGs)
    write_blender_dataset(
        scene, n_train=6, n_val=2, n_test=2, resolution=res, scene="hard"
    )
    assert (scene / "transforms_train.json").exists()

    metrics = train_nerf(
        preset="lego_full",
        data_dir=str(scene),
        max_iters=iters,
        precrop_iters=0,
        log_dir=str(work / "run"),
        render_video=False,
    )
    ckpts = sorted((work / "run" / "ckpt").glob("step_*"))
    row = {
        "ok": bool(ckpts) and "test_psnr_mean" in metrics,
        "test_psnr_mean": round(float(metrics.get("test_psnr_mean", -1)), 2),
        "ckpt_steps": len(ckpts),
        "scene_dir": str(scene),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    run_smoke(res=arg("--res", 64), iters=arg("--iters", 10))
