"""Trace the flagship train step on the GPU and reduce the trace by kernel.

Runs ``train --preset lego_hierarchical --profile-dir <dir>`` (400^2 hard
scene, 4096 rays, 8x256 MLPs, 64+128 samples; the trainer traces 10 steps
after 10 warm-up steps), then reads the ``.xplane.pb`` it wrote and prints:

* the traced window, the device busy time (union of kernel intervals) and
  the idle share;
* device time by kernel class: GEMM (cuBLAS/CUTLASS/XLA dot kernels) and
  everything else (XLA fusions: elementwise, reductions, scatters, copies);
* the MLP GEMMs' achieved FLOP/s (analytic model FLOPs from
  ``bench.model_flops_per_step``) against the H100's dense TF32 and FP32
  peaks;
* XLA's own estimate of the bytes the step accesses
  (``compiled.cost_analysis()``), and the rate the non-GEMM kernels would
  need to move them;
* the top kernels by device time.

    python tools_dev/trace_flagship.py [--out-dir DIR]

Needs a GPU. The summary is also written to ``<out-dir>/summary.json``
(default ``.runs/trace_flagship``), beside the trace itself.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
GEMM_KERNEL = re.compile(r"gemm|xmma|nvjet|cublas|cutlass|sgemm|wgmma", re.I)


def device_kernels(xplane: str):
    """(name, start_ns, duration_ns) of every kernel on the first GPU."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            # stream lines carry the kernels; "XLA Ops"/"XLA Modules" lines
            # repeat them as HLO spans
            if not line.name.lower().startswith("stream"):
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    return out


def busy_ns(kernels) -> float:
    total, end = 0.0, -1.0
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        e = s + d
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default=str(REPO / ".runs" / "trace_flagship"))
    args = p.parse_args(argv)
    out_dir = Path(args.out_dir)

    import jax

    import bench
    from nerf_meets_mlx_tpu.__main__ import main as cli_main
    from nerf_meets_mlx_tpu.config import lego_hierarchical
    from nerf_meets_mlx_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("trace_flagship needs a GPU")
    work = REPO / ".runs" / "trace_flagship"  # the trace, kept out of a small out_dir
    prof = work / "profile"
    cli_main([
        "train", "--preset", "lego_hierarchical", "--synth-scene", "hard",
        "--synth-resolution", "400", "--precrop-iters", "0", "--max-iters", "20",
        "--no-video", "--no-shard", "--no-resume", "--log-dir", str(work / "run"),
        "--profile-dir", str(prof),
    ])
    xplane = sorted(glob.glob(str(prof / "plugins" / "profile" / "*" / "*.xplane.pb")))[-1]
    kernels = device_kernels(xplane)
    if not kernels:
        pd = jax.profiler.ProfileData.from_file(xplane)
        raise SystemExit("no GPU stream events in the trace; planes/lines: " + str(
            [(pl.name, [ln.name for ln in pl.lines]) for pl in pd.planes]))
    n_steps = 10
    window = max(s + d for _, s, d in kernels) - min(s for _, s, _ in kernels)
    busy = busy_ns(kernels)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, _, d in kernels:
        by_name[name][0] += 1
        by_name[name][1] += d
    gemm_ns = sum(t for n, (_, t) in by_name.items() if GEMM_KERNEL.search(n))
    other_ns = sum(t for n, (_, t) in by_name.items() if not GEMM_KERNEL.search(n))

    flops = bench.model_flops_per_step(lego_hierarchical())
    step, state, images, poses, _ = bench.make_bench_setup(4096)
    cost = step.lower(state, images, poses, jax.random.PRNGKey(0)).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    step_bytes = float(cost.get("bytes accessed", float("nan")))

    gemm_s = gemm_ns / n_steps * 1e-9
    other_s = other_ns / n_steps * 1e-9
    summary = {
        "device": jax.devices()[0].device_kind,
        "steps_traced": n_steps,
        "window_ms": window * 1e-6,
        "busy_ms": busy * 1e-6,
        "idle_share": 1.0 - busy / window,
        "per_step_ms": {
            "device_busy": busy * 1e-6 / n_steps,
            "gemm": gemm_s * 1e3,
            "non_gemm": other_s * 1e3,
        },
        "mlp_model_flops_per_step": flops,
        "gemm_tflops_achieved": flops / gemm_s / 1e12,
        "gemm_share_of_tf32_peak": flops / gemm_s / PEAK_TF32,
        "gemm_share_of_fp32_peak": flops / gemm_s / PEAK_FP32,
        "xla_bytes_accessed_per_step": step_bytes,
        "non_gemm_rate_if_all_bytes_tb_s": step_bytes / other_s / 1e12,
        "bytes_floor_ms_at_3.35TB_s": step_bytes / PEAK_BYTES * 1e3,
        "top_kernels": [
            {"name": n[:160], "calls": c, "ms_per_step": t * 1e-6 / n_steps,
             "gemm": bool(GEMM_KERNEL.search(n))}
            for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]
        ],
        "xplane": xplane,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels"}, indent=1))
    for k in summary["top_kernels"][:25]:
        print(f"{k['ms_per_step']:9.3f} ms/step  x{k['calls'] // n_steps:<4} "
              f"{'GEMM ' if k['gemm'] else '     '}{k['name']}")


if __name__ == "__main__":
    main()
