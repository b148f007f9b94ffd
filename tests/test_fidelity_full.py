"""Fidelity chain at the FULL lego configuration (VERDICT r2 weak #2).

The toy-shape gates in test_fidelity.py leave the parity chain unclosed at
scale. This file runs the reference-semantics config at the reference's
actual shapes — D=8 / W=256 / skip@4, 10 pos + 4 dir frequencies with
include_input, 64 coarse + 128 importance samples
(/root/reference/mlx_nerf/config_parser.py:17-23,36-37) — and closes:

  numpy transcription <-> XLA path      (deterministic hierarchical eval,
                                         outputs; coarse train-loss grads
                                         by finite differences)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import EncodingConfig, MLPConfig, RenderConfig, lego_hierarchical
from nerf_meets_mlx_tpu.engine.trainer import nerf_loss_fn
from nerf_meets_mlx_tpu.models import create_nerf
from tests.test_fidelity import (
    _np_encode,
    _np_mlp,
    _np_raw2outputs_reference,
    _np_sample_pdf_det,
)

N_FREQS_POS, MAX_EXP_POS = 10, 9.0
N_FREQS_DIR, MAX_EXP_DIR = 4, 3.0


def _full_cfg(n_importance=128):
    cfg = lego_hierarchical()
    return cfg.replace(
        pos_encoding=EncodingConfig(
            kind="sinusoidal", in_dim=3, n_freqs=N_FREQS_POS,
            frequency_bands="reference_squared", include_input=True,
        ),
        dir_encoding=EncodingConfig(
            kind="sinusoidal", in_dim=3, n_freqs=N_FREQS_DIR,
            frequency_bands="reference_squared", include_input=True,
        ),
        mlp=MLPConfig(net_depth=8, net_width=256, skips=(4,)),
        mlp_fine=MLPConfig(net_depth=8, net_width=256, skips=(4,)),
        render=RenderConfig(
            n_samples=64, n_importance=n_importance, perturb=0.0,
            raw_noise_std=0.0, white_bkgd=False, compositing="reference",
        ),
    )


def _rays(B=4):
    rng = np.random.default_rng(3)
    rays_o = np.zeros((B, 3), np.float32) + np.array([0, 0, 4], np.float32)
    rays_d = rng.normal(size=(B, 3)).astype(np.float32) * 0.2
    rays_d[:, 2] = -1.0
    return jnp.asarray(rays_o), jnp.asarray(rays_d)


def _np_level(p_mlp, cfg, ro, rd, viewdirs, zv):
    pts = ro[:, None, :] + zv[..., None] * rd[:, None, :]
    ep = _np_encode(pts, N_FREQS_POS, MAX_EXP_POS, True, True)
    ed = _np_encode(
        np.broadcast_to(viewdirs[:, None, :], pts.shape),
        N_FREQS_DIR, MAX_EXP_DIR, True, True,
    )
    raw = _np_mlp(p_mlp, cfg.mlp, ep, ed)
    return _np_raw2outputs_reference(raw, zv, rd)


def _np_hierarchical(params, cfg, ro, rd):
    B, n = ro.shape[0], cfg.render.n_samples
    viewdirs = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    t = np.linspace(0, 1, n, dtype=np.float32)
    z = np.broadcast_to(
        cfg.render.near * (1 - t) + cfg.render.far * t, (B, n)
    ).astype(np.float32)
    p_c = jax.tree_util.tree_map(np.asarray, params["coarse"])
    rgb_c, w_c = _np_level(p_c, cfg, ro, rd, viewdirs, z)
    if cfg.render.n_importance == 0:
        return rgb_c, w_c, None
    z_imp = _np_sample_pdf_det(z, w_c, cfg.render.n_importance)
    z_all = np.sort(np.concatenate([z, z_imp], -1), -1)
    p_f = jax.tree_util.tree_map(np.asarray, params["fine"])
    rgb_f, _ = _np_level(p_f, cfg, ro, rd, viewdirs, z_all)
    return rgb_c, w_c, rgb_f


def test_full_scale_eval_outputs_match_numpy():
    """numpy <-> XLA at D=8/W=256, 10/4 freqs, 64+128 samples (eval path:
    deterministic inverse-CDF, the render_rays_eval semantics)."""
    cfg = _full_cfg()
    model = create_nerf(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rays_o, rays_d = _rays()

    out = model.render_rays(params, rays_o, rays_d, key=None, train=False)
    rgb_c, w_c, rgb_f = _np_hierarchical(params, cfg, np.asarray(rays_o), np.asarray(rays_d))

    np.testing.assert_allclose(np.asarray(out["rgb_coarse"]), rgb_c, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out["weights"]), w_c, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out["rgb_fine"]), rgb_f, rtol=2e-4, atol=5e-5)


def test_full_scale_coarse_grads_match_numpy_fd():
    """numpy <-> XLA train-path gradients at full scale (coarse-only so the
    pipeline is deterministic): finite differences of the numpy
    transcription vs the analytic grads, spot-checked across layers (first,
    skip, last, heads)."""
    cfg = _full_cfg(n_importance=0)
    model = create_nerf(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rays_o, rays_d = _rays(B=3)
    target = jnp.full((3, 3), 0.4)
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return nerf_loss_fn(model, p, rays_o, rays_d, target, key)[0]

    g = jax.grad(loss_fn)(params)

    params_np = jax.tree_util.tree_map(np.asarray, params["coarse"])
    ro, rd, tgt = np.asarray(rays_o), np.asarray(rays_d), np.asarray(target)
    viewdirs = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    t = np.linspace(0, 1, cfg.render.n_samples, dtype=np.float32)
    z = np.broadcast_to(
        cfg.render.near * (1 - t) + cfg.render.far * t, (3, cfg.render.n_samples)
    ).astype(np.float32)

    def np_loss(p_np):
        rgb, _ = _np_level(p_np, cfg, ro, rd, viewdirs, z)
        return np.mean((rgb - tgt) ** 2)

    rng = np.random.default_rng(2)
    eps = 1e-3
    sites = [
        (("pos_linears", 0), "w"),
        (("pos_linears", 5), "w"),   # first layer after the skip concat
        (("pos_linears", 7), "w"),
        (("alpha_linear",), "b"),
        (("rgb_linear",), "w"),
    ]
    for path, leaf in sites:
        node = g["coarse"]
        node_np = params_np
        for k in path:
            node = node[k]
            node_np = node_np[k]
        arr = np.asarray(node[leaf])
        flat_idx = rng.integers(0, arr.size)
        idx = np.unravel_index(flat_idx, arr.shape)
        p_plus = jax.tree_util.tree_map(np.copy, params_np)
        p_minus = jax.tree_util.tree_map(np.copy, params_np)
        tp, tm = p_plus, p_minus
        for k in path:
            tp, tm = tp[k], tm[k]
        tp[leaf][idx] += eps
        tm[leaf][idx] -= eps
        fd = (np_loss(p_plus) - np_loss(p_minus)) / (2 * eps)
        np.testing.assert_allclose(
            arr[idx], fd, rtol=8e-2, atol=2e-5,
            err_msg=f"FD mismatch at coarse/{path}/{leaf}{idx}",
        )
