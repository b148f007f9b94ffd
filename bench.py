"""Benchmark harness: train-step throughput (rays/s, forward + backward).

Measures the jitted hierarchical train step (coarse 64 + fine 192-sample
passes, importance resampling, grads, Adam) at the reference's run-defining
batch of N_rand=4096 rays.

Prints ONE JSON line naming the device it ran on:
  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s",
   "step_ms": T, "device": {"platform": ..., "kind": ..., "count": ...}}

Options: ``--preset NAME``, ``--config-txt PATH``, ``--inner N`` (lax.scan
step batching), ``--scaling`` (weak scaling over the visible devices),
``--sweep`` (rays/s against the per-step ray batch).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def device_info() -> dict:
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def make_bench_setup(
    n_rand: int = 4096,
    preset: str = "lego_hierarchical",
    n_inner: int = 1,
    config_txt: Optional[str] = None,
):
    from nerf_meets_mlx_tpu.config import PRESETS, config_from_text
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.engine.trainer import make_nerf_train_step
    from nerf_meets_mlx_tpu.models import create_nerf

    cfg = PRESETS[preset]()
    if config_txt:
        cfg = config_from_text(config_txt, base=cfg)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, n_rand=n_rand, precrop_iters=0),
    )
    model = create_nerf(cfg)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    step = make_nerf_train_step(model, H, W, focal, n_inner=n_inner)
    occ = None
    if cfg.render.occupancy:
        from nerf_meets_mlx_tpu.acceleration.occupancy import init_occupancy_grid

        occ = init_occupancy_grid(cfg.render.occ_resolution)
    state = create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train, occ)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.uniform(size=(8, H, W, 3)), jnp.float32)
    poses = jnp.asarray(
        np.stack(
            [np.eye(4, dtype=np.float32)[:3] for _ in range(8)]
        )
    )
    # look-from-distance poses so rays traverse the scene volume
    poses = poses.at[:, 2, 3].set(4.0)
    return step, state, images, poses, n_rand


def bench_train_step(
    n_warmup: int = 5, n_iters: int = 50, n_rand: int = 4096,
    preset: str = "lego_hierarchical", n_inner: int = 1,
    config_txt: Optional[str] = None,
) -> float:
    """Returns train rays/sec. With n_inner > 1 each dispatch advances
    n_inner optimizer steps via the trainer's lax.scan step batching
    (same training semantics)."""
    n_inner = max(1, n_inner)  # --inner 0/negative would break the ceil-divs
    step, state, images, poses, n_rand = make_bench_setup(
        n_rand, preset=preset, n_inner=n_inner, config_txt=config_txt
    )
    key = jax.random.PRNGKey(0)
    n_warmup = -(-n_warmup // n_inner)
    n_calls = -(-n_iters // n_inner)
    for _ in range(n_warmup):
        state, aux = step(state, images, poses, key)
    jax.block_until_ready((state, aux))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state, aux = step(state, images, poses, key)
    jax.block_until_ready((state, aux))
    dt = time.perf_counter() - t0
    return n_rand * n_calls * n_inner / dt


def model_flops_per_step(cfg) -> Optional[float]:
    """Analytic MODEL FLOPs of one train step (fwd + backward ~= 3x fwd),
    counting the MLP GEMM math at logical dims for both levels over the
    n_rand ray batch. Returns None for learned-table encodings (hash/CP):
    their lookups are memory ops, not model FLOPs — an "MFU" there would
    be structurally near-zero and misleading."""
    from nerf_meets_mlx_tpu.models import create_nerf

    if cfg.pos_encoding.kind != "sinusoidal":
        return None
    model = create_nerf(cfg)
    in_dim = model.pos_enc.out_dim
    dir_dim = model.dir_enc.out_dim if model.dir_enc is not None else 0

    def point_macs(mlp):
        W, D = mlp.net_width, mlp.net_depth
        macs = in_dim * W
        for j in range(1, D):
            macs += W * W + (in_dim * W if (j - 1) in mlp.skips else 0)
        if mlp.use_viewdirs:
            macs += W * 1 + W * W + (W + dir_dim) * (W // 2) + (W // 2) * 3
        else:
            macs += W * mlp.out_channels
        return macs

    rcfg = cfg.render
    B = cfg.train.n_rand
    pts_c = B * rcfg.n_samples
    pts_f = B * (rcfg.n_samples + rcfg.n_importance) if rcfg.n_importance else 0
    fine_mlp = cfg.mlp_fine or cfg.mlp
    fwd = pts_c * point_macs(cfg.mlp) + pts_f * point_macs(fine_mlp)
    return 3.0 * 2.0 * fwd  # fwd + bwd(2x), MACs -> FLOPs


def bench_scaling(n_devices: int = 0, rays_per_device: int = 4096, n_iters: int = 30):
    """Weak scaling: the sharded step at 1 device vs N devices with
    rays_per_device held constant. Prints one JSON line with
    efficiency = T1 / TN (1.0 = perfect weak scaling)."""
    from nerf_meets_mlx_tpu.config import lego_hierarchical
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.models import create_nerf
    from nerf_meets_mlx_tpu.parallel import (
        make_mesh,
        make_sharded_nerf_train_step,
        replicate_state,
        replicated,
    )

    n_devices = n_devices or len(jax.devices())
    cfg = lego_hierarchical()
    model = create_nerf(cfg)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, H, W, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[None, :3, :4], (4, 1, 1))
    poses[:, 2, 3] = 4.0

    def measure(nd):
        mesh = make_mesh(nd)
        step = make_sharded_nerf_train_step(
            model, H, W, focal, mesh, n_rand_per_device=rays_per_device
        )
        state = replicate_state(
            create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train), mesh
        )
        imgs = jax.device_put(images, replicated(mesh))
        ps = jax.device_put(poses, replicated(mesh))
        key = jax.random.PRNGKey(0)
        for _ in range(3):
            state, aux = step(state, imgs, ps, key)
        jax.block_until_ready((state, aux))
        t0 = time.perf_counter()
        for _ in range(n_iters):
            state, aux = step(state, imgs, ps, key)
        jax.block_until_ready((state, aux))
        dt = (time.perf_counter() - t0) / n_iters
        return rays_per_device * nd / dt, dt

    rps1, t1 = measure(1)
    rpsN, tN = measure(n_devices)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": t1 / tN,
        "unit": f"T1/T{n_devices} (rays/device={rays_per_device})",
        "step_ms_1dev": t1 * 1000,
        "step_ms_ndev": tN * 1000,
        "rays_per_sec_1dev": rps1,
        "rays_per_sec_ndev": rpsN,
        "device": device_info(),
    }))


def bench_sweep(preset: str = "lego_hierarchical"):
    """Rays/s against the per-step ray batch on one device. Prints one JSON
    line."""
    points = []
    for n_rand in (1024, 2048, 4096, 8192, 16384, 32768):
        rps = bench_train_step(n_warmup=3, n_iters=20, n_rand=n_rand, preset=preset)
        points.append({"n_rand": n_rand, "rays_per_sec": rps})
        print(f"# n_rand={n_rand}: {rps:,.0f} rays/s", flush=True)
    print(json.dumps({
        "metric": "rays_per_sec_by_batch",
        "preset": preset,
        "points": points,
        "device": device_info(),
    }))


def main():
    import sys

    from nerf_meets_mlx_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    preset = "lego_hierarchical"
    if "--preset" in sys.argv:  # e.g. --preset lego_occ: accelerated configs
        preset = sys.argv[sys.argv.index("--preset") + 1]
    if "--scaling" in sys.argv:
        bench_scaling()
        return
    if "--sweep" in sys.argv:
        bench_sweep(preset)
        return
    n_inner = 1
    if "--inner" in sys.argv:  # lax.scan step batching (trainer n_inner)
        n_inner = int(sys.argv[sys.argv.index("--inner") + 1])
    config_txt = None
    if "--config-txt" in sys.argv:  # key=value overlay (variant benching)
        config_txt = sys.argv[sys.argv.index("--config-txt") + 1]
    bench_n_rand = 4096
    rays_per_sec = bench_train_step(
        n_rand=bench_n_rand, preset=preset, n_inner=n_inner, config_txt=config_txt
    )
    metric = (
        "train_rays_per_sec"
        if preset == "lego_hierarchical"
        else f"train_rays_per_sec[{preset}]"
    )
    print(json.dumps({
        "metric": metric,
        "value": rays_per_sec,
        "unit": "rays/s",
        "step_ms": bench_n_rand / rays_per_sec * 1000,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
