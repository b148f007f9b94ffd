"""The plain (XLA) hot path against independent float64 NumPy references.

Covers what the removed Pallas kernels were checked for, now on the one path
that remains: compositing (both modes, both density activations, white
background), whole-ray rendering at assorted ray and sample counts, the
hash-grid encode and its table gradient, the CP-grid encode and its line
gradient, the MLP (deep skips, squared frequency bands, both heads), the
image-learning step, and eval-mode gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_meets_mlx_tpu.config import (
    EncodingConfig,
    MLPConfig,
    RenderConfig,
    image2d,
    lego_cp,
    lego_hierarchical,
    lego_ingp,
)
from nerf_meets_mlx_tpu.encoding.cp_grid import CPGridEncoding
from nerf_meets_mlx_tpu.encoding.hash_grid import HashGridEncoding, _level_resolutions
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.engine.trainer import make_image_train_step
from nerf_meets_mlx_tpu.models import create_nerf
from nerf_meets_mlx_tpu.rendering.volume import raw2outputs

F64 = np.float64


# ---------------------------------------------------------------------------
# float64 NumPy references
# ---------------------------------------------------------------------------


def np_composite(raw, z, rays_d, mode, act, white):
    raw, z, rays_d = (np.asarray(a, F64) for a in (raw, z, rays_d))
    deltas = np.diff(z, axis=-1)
    deltas = np.concatenate([deltas, np.full_like(deltas[..., :1], 1e10)], -1)
    deltas = deltas * np.linalg.norm(rays_d, axis=-1)[..., None]
    if mode == "reference":
        dd = deltas * raw[..., 3]
        alpha = 1.0 - np.exp(-np.maximum(dd, 0.0))
        rgb = raw[..., :3]
    else:
        s = raw[..., 3]
        sigma = np.log1p(np.exp(s)) if act == "softplus" else np.maximum(s, 0.0)
        dd = sigma * deltas
        alpha = 1.0 - np.exp(-dd)
        rgb = 1.0 / (1.0 + np.exp(-raw[..., :3]))
    excl = np.concatenate([np.zeros_like(dd[..., :1]), np.cumsum(dd[..., :-1], -1)], -1)
    w = alpha * np.exp(-excl)
    acc = w.sum(-1)
    out = {
        "rgb_map": (w[..., None] * rgb).sum(-2) + (1.0 - acc[..., None] if white else 0.0),
        "depth_map": (w * z).sum(-1),
        "acc_map": acc,
        "weights": w,
    }
    out["disp_map"] = 1.0 / np.maximum(1e-10, out["depth_map"] / np.maximum(acc, 1e-10))
    return out


def np_encode(x, n_freqs, include_input, squared):
    x = np.asarray(x, F64)
    lin = np.linspace(0.0, n_freqs - 1, n_freqs)
    bands = lin**2 if squared else 2.0**lin
    scaled = (x[..., None] * bands).reshape(*x.shape[:-1], -1)
    out = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=-1)
    return np.concatenate([out, x], axis=-1) if include_input else out


def np_mlp(params, cfg, x_pos, x_dir):
    def lin(p, h):
        return h @ np.asarray(p["w"], F64) + np.asarray(p["b"], F64)

    h = x_pos
    for idx, p in enumerate(params["pos_linears"]):
        h = np.maximum(lin(p, h), 0.0)
        if idx in cfg.skips:
            h = np.concatenate([x_pos, h], axis=-1)
    if not cfg.use_viewdirs:
        return lin(params["output_linear"], h)
    alpha = lin(params["alpha_linear"], h)
    h = np.concatenate([lin(params["feature_linear"], h), x_dir], axis=-1)
    rgb = lin(params["rgb_linear"], np.maximum(lin(params["dir_linear"], h), 0.0))
    return np.concatenate([rgb, alpha], axis=-1)


def np_sample_pdf_det(z, w, n_imp, eps=1e-5):
    B, n = w.shape
    w = w + 0.01
    s = w.sum(-1, keepdims=True)
    pad = np.maximum(eps - s, 0.0)
    w, s = w + pad / n, s + pad
    cdf = np.concatenate([np.zeros((B, 1)), np.minimum(1.0, np.cumsum(w / s, -1))], -1)
    u = np.linspace(0.0, 1.0, n_imp)
    zm = 0.5 * (z[:, 1:] + z[:, :-1])
    zm = np.concatenate([zm[:, :1], zm, zm[:, -1:]], -1)
    out = np.empty((B, n_imp))
    for b in range(B):
        inds = np.searchsorted(cdf[b], u, side="right")
        lo, hi = np.clip(inds - 1, 0, n), np.clip(inds, 0, n)
        den = cdf[b][hi] - cdf[b][lo]
        den = np.where(den < eps, 1.0, den)
        t = np.clip((u - cdf[b][lo]) / den, 0.0, 1.0)
        out[b] = zm[b][lo] + t * (zm[b][hi] - zm[b][lo])
    return out


def np_hash_encode(tables, x, enc: HashGridEncoding):
    """Returns features [N, L*F] and, per level and corner, (index, weight)."""
    tables = np.asarray(tables, F64)
    L, T, F = tables.shape
    u = np.clip((np.asarray(x, F64) - enc.bbox_min) / (enc.bbox_max - enc.bbox_min), 0, 1)
    res = _level_resolutions(L, enc.min_res, enc.max_res).astype(F64)
    primes = (1, 2654435761, 805459861)
    feats = np.zeros((x.shape[0], L, F))
    taps = []
    for lv in range(L):
        scaled = u * res[lv]
        base = np.floor(scaled)
        frac = scaled - base
        base = base.astype(np.uint64)
        for c in range(8):
            bits = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
            h = np.zeros(x.shape[0], np.uint64)
            w = np.ones(x.shape[0])
            for d in range(3):
                h ^= ((base[:, d] + np.uint64(bits[d])) * np.uint64(primes[d])) & np.uint64(0xFFFFFFFF)
                w *= frac[:, d] if bits[d] else 1.0 - frac[:, d]
            idx = (h & np.uint64(T - 1)).astype(np.int64)
            feats[:, lv] += tables[lv, idx] * w[:, None]
            taps.append((lv, idx, w))
    return feats.reshape(x.shape[0], L * F), taps


def np_cp_encode(lines, x, enc: CPGridEncoding):
    """Returns features [N, L*C] and the per-level, per-axis line values."""
    u = np.clip((np.asarray(x, F64) - enc.bbox_min) / (enc.bbox_max - enc.bbox_min), 0, 1)
    feats, per_axis = [], []
    for lv, r in enumerate(enc.resolutions):
        t = u * (int(r) - 1)
        lo = np.minimum(np.floor(t).astype(np.int64), int(r) - 1)
        hi = np.minimum(lo + 1, int(r) - 1)
        f = t - lo
        ln = np.asarray(lines[lv], F64)
        vals = [
            ln[a][lo[:, a]] * (1 - f[:, a, None]) + ln[a][hi[:, a]] * f[:, a, None]
            for a in range(3)
        ]
        per_axis.append((lo, hi, f, vals))
        feats.append(vals[0] * vals[1] * vals[2])
    return np.concatenate(feats, -1), per_axis


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------


def _composite_inputs(B=5, S=7, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(B, S, 4)).astype(np.float32) * 2.0
    z = np.sort(rng.uniform(2.0, 6.0, size=(B, S)), -1).astype(np.float32)
    rays_d = rng.normal(size=(B, 3)).astype(np.float32)
    return raw, z, rays_d


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("mode", ["canonical", "reference"])
def test_composite_matches_float64_reference(mode, act, white):
    raw, z, rays_d = _composite_inputs()
    got = raw2outputs(
        jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d), mode=mode,
        white_bkgd=white, density_activation=act,
    )
    ref = np_composite(raw, z, rays_d, mode, act, white)
    for k in ("rgb_map", "depth_map", "acc_map", "weights", "disp_map"):
        np.testing.assert_allclose(np.asarray(got[k]), ref[k], rtol=2e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("mode", ["canonical", "reference"])
def test_composite_grads_match_float64_fd(mode, white):
    """d(sum(rgb * c) + sum(depth)) / d raw against central differences of
    the float64 reference."""
    raw, z, rays_d = _composite_inputs(B=3, S=6, seed=1)
    c = np.random.default_rng(2).normal(size=(3, 3))

    def loss(r):
        out = raw2outputs(r, jnp.asarray(z), jnp.asarray(rays_d), mode=mode, white_bkgd=white)
        return jnp.sum(out["rgb_map"] * c) + jnp.sum(out["depth_map"]) * 0.1

    g = np.asarray(jax.grad(loss)(jnp.asarray(raw)))

    def np_loss(r):
        out = np_composite(r, z, rays_d, mode, "softplus", white)
        return np.sum(out["rgb_map"] * c) + np.sum(out["depth_map"]) * 0.1

    eps = 1e-5
    fd = np.zeros_like(g, dtype=F64)
    for idx in np.ndindex(raw.shape):
        rp, rm = raw.astype(F64), raw.astype(F64)
        rp[idx] += eps
        rm[idx] -= eps
        fd[idx] = (np_loss(rp) - np_loss(rm)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-3, atol=2e-4 * np.abs(fd).max())


# ---------------------------------------------------------------------------
# whole rays: encode -> MLP -> composite -> resample -> fine pass
# ---------------------------------------------------------------------------


def _ray_cfg(n_samples, n_importance, mode):
    cfg = lego_hierarchical()
    mlp = MLPConfig(net_depth=4, net_width=24, skips=(1,))
    return cfg.replace(
        pos_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=5),
        dir_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=3),
        mlp=mlp,
        mlp_fine=mlp,
        render=RenderConfig(
            n_samples=n_samples, n_importance=n_importance, perturb=0.0,
            raw_noise_std=0.0, white_bkgd=True, compositing=mode,
        ),
    )


def _np_render(params, cfg, ro, rd):
    ro, rd = ro.astype(F64), rd.astype(F64)
    B, n = ro.shape[0], cfg.render.n_samples
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    t = np.linspace(0.0, 1.0, n)
    z = np.broadcast_to(cfg.render.near * (1 - t) + cfg.render.far * t, (B, n))

    def level(p, zv):
        pts = ro[:, None] + zv[..., None] * rd[:, None]
        raw = np_mlp(
            p, cfg.mlp, np_encode(pts, 5, True, False),
            np_encode(np.broadcast_to(vd[:, None], pts.shape), 3, True, False),
        )
        return np_composite(raw, zv, rd, cfg.render.compositing, "softplus", True)

    out_c = level(jax.tree_util.tree_map(np.asarray, params["coarse"]), z)
    if not cfg.render.n_importance:
        return out_c, None
    z_imp = np_sample_pdf_det(z, out_c["weights"], cfg.render.n_importance)
    z_all = np.sort(np.concatenate([z, z_imp], -1), -1)
    return out_c, level(jax.tree_util.tree_map(np.asarray, params["fine"]), z_all)


@pytest.mark.parametrize(
    "B,S,n_imp,mode",
    [(1, 8, 0, "canonical"), (10, 8, 4, "canonical"), (25, 12, 8, "reference"), (37, 5, 3, "canonical")],
)
def test_render_rays_shapes_match_float64_reference(B, S, n_imp, mode):
    cfg = _ray_cfg(S, n_imp, mode)
    model = create_nerf(cfg)
    params = model.init(jax.random.PRNGKey(B))
    rng = np.random.default_rng(B)
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (B, 1))
    rd = (rng.normal(size=(B, 3)) * 0.2).astype(np.float32)
    rd[:, 2] = -1.0
    out = model.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), key=None, train=False)
    ref_c, ref_f = _np_render(params, cfg, ro, rd)
    assert out["rgb_map"].shape == (B, 3) and out["weights"].shape == (B, S)
    np.testing.assert_allclose(np.asarray(out["rgb_coarse"]), ref_c["rgb_map"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out["weights"]), ref_c["weights"], rtol=1e-4, atol=1e-5)
    if n_imp:
        np.testing.assert_allclose(np.asarray(out["rgb_fine"]), ref_f["rgb_map"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(np.asarray(out["depth_fine"]), ref_f["depth_map"], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# hash grid
# ---------------------------------------------------------------------------

HASH_CASES = [(1, 1, 6, 4, 16), (2, 2, 8, 8, 64), (4, 2, 10, 16, 256), (8, 4, 8, 4, 128), (16, 2, 12, 16, 512)]


def _hash_setup(L, F, log2T, min_res, max_res, N=200):
    enc = HashGridEncoding(
        n_levels=L, features_per_level=F, log2_table_size=log2T,
        min_res=min_res, max_res=max_res, init_scale=1.0,
    )
    tables = enc.init_params(jax.random.PRNGKey(L * 10 + F))["tables"]
    x = np.random.default_rng(L).uniform(-1.6, 1.6, size=(N, 3)).astype(np.float32)
    return enc, tables, x


@pytest.mark.parametrize("L,F,log2T,min_res,max_res", HASH_CASES)
def test_hash_grid_forward_matches_float64_reference(L, F, log2T, min_res, max_res):
    enc, tables, x = _hash_setup(L, F, log2T, min_res, max_res)
    got = enc.apply({"tables": tables}, jnp.asarray(x).reshape(20, 10, 3))
    ref, _ = np_hash_encode(tables, x, enc)
    assert got.shape == (20, 10, L * F)
    # the float32 path scales positions to [0, max_res] before taking the
    # fractional part, so corner weights carry ~max_res * 2^-24 of rounding
    np.testing.assert_allclose(
        np.asarray(got).reshape(-1, L * F), ref, rtol=1e-5, atol=max_res * 2.0**-20
    )


@pytest.mark.parametrize("L,F,log2T,min_res,max_res", HASH_CASES)
def test_hash_grid_table_grads_match_float64_scatter(L, F, log2T, min_res, max_res):
    """d sum(feats * c) / d tables is the scatter-add of corner weight x c."""
    enc, tables, x = _hash_setup(L, F, log2T, min_res, max_res)
    c = np.random.default_rng(F).normal(size=(x.shape[0], L * F))
    g = jax.grad(lambda t: jnp.sum(enc.apply({"tables": t}, jnp.asarray(x)) * c))(tables)
    _, taps = np_hash_encode(tables, x, enc)
    ref = np.zeros(tables.shape)
    cl = c.reshape(x.shape[0], L, F)
    for lv, idx, w in taps:
        np.add.at(ref[lv], idx, w[:, None] * cl[:, lv])
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-4, atol=max_res * 2.0**-18)


# ---------------------------------------------------------------------------
# CP grid
# ---------------------------------------------------------------------------

CP_CASES = [(1, 4, 8, 8), (2, 8, 16, 64), (4, 16, 64, 512)]


def _cp_setup(levels, comps, min_res, max_res, N=150):
    enc = CPGridEncoding(
        n_levels=levels, n_components=comps, min_res=min_res, max_res=max_res,
        compute_dtype="float32",
    )
    lines = enc.init_params(jax.random.PRNGKey(comps))["lines"]
    x = np.random.default_rng(comps).uniform(-1.6, 1.6, size=(N, 3)).astype(np.float32)
    return enc, lines, x


@pytest.mark.parametrize("levels,comps,min_res,max_res", CP_CASES)
def test_cp_grid_forward_matches_float64_reference(levels, comps, min_res, max_res):
    enc, lines, x = _cp_setup(levels, comps, min_res, max_res)
    got = enc.apply({"lines": lines}, jnp.asarray(x))
    ref, _ = np_cp_encode(lines, x, enc)
    # float32 rounding of the scaled position, as for the hash grid
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=max_res * 2.0**-26)


@pytest.mark.parametrize("levels,comps,min_res,max_res", CP_CASES)
def test_cp_grid_line_grads_match_float64_reference(levels, comps, min_res, max_res):
    """d sum(feats * c) / d line_a = scatter of the hat weights times c times
    the other two axes' interpolated values."""
    enc, lines, x = _cp_setup(levels, comps, min_res, max_res)
    c = np.random.default_rng(levels).normal(size=(x.shape[0], levels * comps))
    g = jax.grad(lambda ls: jnp.sum(enc.apply({"lines": ls}, jnp.asarray(x)) * c))(lines)
    _, per_axis = np_cp_encode(lines, x, enc)
    for lv, (lo, hi, f, vals) in enumerate(per_axis):
        cl = c[:, lv * comps:(lv + 1) * comps]
        ref = np.zeros(np.asarray(lines[lv]).shape)
        for a in range(3):
            others = np.prod([vals[b] for b in range(3) if b != a], axis=0) * cl
            np.add.at(ref[a], lo[:, a], (1 - f[:, a, None]) * others)
            np.add.at(ref[a], hi[:, a], f[:, a, None] * others)
        np.testing.assert_allclose(np.asarray(g[lv]), ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MLP + sinusoidal encodings
# ---------------------------------------------------------------------------

MLP_CASES = [
    (8, 32, (4,), "canonical", True),
    (8, 32, (2, 5), "reference_squared", True),
    (6, 24, (1, 3), "reference_squared", True),
    (3, 16, (0,), "canonical", True),
    (4, 16, (), "canonical", False),
    (2, 64, (), "reference_squared", False),
]


def _mlp_model(depth, width, skips, bands, viewdirs):
    cfg = lego_hierarchical()
    mlp = MLPConfig(net_depth=depth, net_width=width, skips=skips, use_viewdirs=viewdirs)
    return create_nerf(cfg.replace(
        pos_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=6, frequency_bands=bands),
        dir_encoding=EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=3, frequency_bands=bands),
        mlp=mlp, mlp_fine=mlp,
    ))


@pytest.mark.parametrize("depth,width,skips,bands,viewdirs", MLP_CASES)
def test_query_matches_float64_reference(depth, width, skips, bands, viewdirs):
    model = _mlp_model(depth, width, skips, bands, viewdirs)
    params = model.init(jax.random.PRNGKey(depth))
    rng = np.random.default_rng(depth)
    pts = rng.uniform(-1.5, 1.5, size=(6, 5, 3)).astype(np.float32)
    vd = rng.normal(size=(6, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    got = model.query(params, "coarse", jnp.asarray(pts), jnp.asarray(vd) if viewdirs else None)
    sq = bands == "reference_squared"
    ref = np_mlp(
        jax.tree_util.tree_map(np.asarray, params["coarse"]), model.cfg.mlp,
        np_encode(pts, 6, True, sq), np_encode(np.broadcast_to(vd[:, None], pts.shape), 3, True, sq),
    )
    assert got.shape == (6, 5, ref.shape[-1])
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("depth,width,skips,bands,viewdirs", [MLP_CASES[1], MLP_CASES[4]])
def test_query_param_grads_match_float64_fd(depth, width, skips, bands, viewdirs):
    """First-layer and output-layer weight gradients of sum(raw * c) against
    central differences of the float64 reference."""
    model = _mlp_model(depth, width, skips, bands, viewdirs)
    params = model.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 1.5, size=(4, 3, 3)).astype(np.float32)
    vd = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    c = rng.normal(size=(4, 3, 4))
    sq = bands == "reference_squared"
    ep = np_encode(pts, 6, True, sq)
    ed = np_encode(np.broadcast_to(vd[:, None], pts.shape), 3, True, sq)

    def loss(p):
        return jnp.sum(model.query(p, "coarse", jnp.asarray(pts), jnp.asarray(vd)) * c)

    g = jax.grad(loss)(params)["coarse"]
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, F64), params["coarse"])
    head = "rgb_linear" if viewdirs else "output_linear"
    for path in (("pos_linears", 0), (head,)):
        ga, node = g, p64
        for k in path:
            ga, node = ga[k], node[k]
        for idx in [(0, 0), (1, 2), (-1, -1)]:
            old = node["w"][idx]
            node["w"][idx] = old + 1e-6
            lp = np.sum(np_mlp(p64, model.cfg.mlp, ep, ed) * c)
            node["w"][idx] = old - 1e-6
            lm = np.sum(np_mlp(p64, model.cfg.mlp, ep, ed) * c)
            node["w"][idx] = old
            np.testing.assert_allclose(
                np.asarray(ga["w"])[idx], (lp - lm) / 2e-6, rtol=2e-3, atol=2e-4
            )


# ---------------------------------------------------------------------------
# 2-D image step
# ---------------------------------------------------------------------------


def _image_setup():
    cfg = image2d()
    cfg = cfg.replace(
        mlp=dataclasses.replace(cfg.mlp, net_depth=3, net_width=32, skips=()),
        train=dataclasses.replace(cfg.train, n_rand=64),
    )
    model = create_nerf(cfg)
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(100, 2)).astype(np.float32)
    colors = rng.uniform(size=(100, 3)).astype(np.float32)
    return cfg, model, coords, colors


def _image_np_loss(params, cfg, x, y):
    pred = np_mlp(params, cfg.mlp, np_encode_image(x, cfg), None)
    return np.mean((pred - y) ** 2)


def np_encode_image(x, cfg):
    pe = cfg.pos_encoding
    bands = 2.0 ** np.linspace(0.0, pe.max_freq_exp, pe.n_freqs)
    scaled = (np.asarray(x, F64)[..., None] * bands).reshape(*x.shape[:-1], -1)
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=-1)


def test_image_step_loss_matches_float64_reference():
    cfg, model, coords, colors = _image_setup()
    step = make_image_train_step(model)
    params = model.init(jax.random.PRNGKey(0))
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, F64), params["coarse"])
    state = create_train_state(params, cfg.train)
    key = jax.random.PRNGKey(5)
    # the step draws its batch from fold_in(key, step)
    idx = np.asarray(jax.random.randint(jax.random.fold_in(key, 0), (64,), 0, 100))
    ref = _image_np_loss(p64, cfg, coords[idx], colors[idx])
    _, aux = step(state, jnp.asarray(coords), jnp.asarray(colors), key)
    np.testing.assert_allclose(float(aux["loss"]), ref, rtol=1e-4)
    np.testing.assert_allclose(float(aux["psnr"]), -10 * np.log10(ref), rtol=1e-4)


def test_image_loss_grads_match_float64_fd():
    cfg, model, coords, colors = _image_setup()
    params = model.init(jax.random.PRNGKey(1))

    def loss(p):
        pred = model.query(p, "coarse", jnp.asarray(coords)[:, None, :], None)[:, 0, :]
        return jnp.mean((pred - jnp.asarray(colors)) ** 2)

    g = jax.grad(loss)(params)["coarse"]
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, F64), params["coarse"])
    for name, idx in ((("pos_linears", 0), (3, 5)), (("output_linear",), (7, 1))):
        ga, node = g, p64
        for k in name:
            ga, node = ga[k], node[k]
        old = node["w"][idx]
        node["w"][idx] = old + 1e-6
        lp = _image_np_loss(p64, cfg, coords, colors)
        node["w"][idx] = old - 1e-6
        lm = _image_np_loss(p64, cfg, coords, colors)
        node["w"][idx] = old
        np.testing.assert_allclose(np.asarray(ga["w"])[idx], (lp - lm) / 2e-6, rtol=2e-3, atol=1e-6)


def test_image_step_reduces_loss():
    cfg, model, coords, colors = _image_setup()
    step = make_image_train_step(model)
    state = create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train)
    key = jax.random.PRNGKey(0)
    c, y = jnp.asarray(coords), jnp.asarray(colors)
    losses = []
    for _ in range(60):
        state, aux = step(state, c, y, key)
        losses.append(float(aux["loss"]))
    assert int(state.step) == 60
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])


# ---------------------------------------------------------------------------
# eval-mode gradients
# ---------------------------------------------------------------------------


def _noise_off(cfg, n_importance=0):
    tiny = MLPConfig(net_depth=cfg.mlp.net_depth, net_width=16, skips=cfg.mlp.skips)
    pe = cfg.pos_encoding
    if pe.kind == "hash_grid":
        pe = dataclasses.replace(pe, hash_log2_table_size=10)
    return cfg.replace(
        pos_encoding=pe, mlp=tiny, mlp_fine=tiny,
        render=dataclasses.replace(
            cfg.render, n_samples=8, n_importance=n_importance, perturb=0.0,
            raw_noise_std=0.0,
        ),
    )


@pytest.mark.parametrize("preset", [lego_hierarchical, lego_ingp, lego_cp])
def test_eval_grads_equal_train_grads_with_noise_off(preset):
    """With no jitter, no density noise and no random resampling, train=True
    and train=False are one program, so their gradients agree — eval-mode
    rendering is differentiable (pose refinement, test-time optimisation)."""
    cfg = _noise_off(preset())
    model = create_nerf(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ro = jnp.asarray(np.tile([[0.0, 0.0, 4.0]], (6, 1)), jnp.float32)
    rd = jnp.asarray(np.c_[rng.normal(size=(6, 2)) * 0.2, -np.ones(6)], jnp.float32)
    tgt = jnp.asarray(rng.uniform(size=(6, 3)), jnp.float32)

    def loss(p, train):
        out = model.render_rays(p, ro, rd, key=jax.random.PRNGKey(1), train=train)
        return jnp.mean((out["rgb_map"] - tgt) ** 2)

    g_train = jax.grad(loss)(params, True)
    g_eval = jax.grad(loss)(params, False)
    leaves = jax.tree_util.tree_leaves(g_eval)
    assert any(float(jnp.abs(x).max()) > 0 for x in leaves)
    for a, b in zip(jax.tree_util.tree_leaves(g_train), leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-8)


def test_eval_grads_reach_both_levels():
    """Hierarchical eval render: the loss on the fine rgb gives non-zero,
    finite gradients to the fine MLP and, through the coarse map, the
    coarse MLP."""
    cfg = _noise_off(lego_hierarchical(), n_importance=8)
    model = create_nerf(cfg)
    params = model.init(jax.random.PRNGKey(0))
    ro = jnp.asarray(np.tile([[0.0, 0.0, 4.0]], (4, 1)), jnp.float32)
    rd = jnp.asarray([[0.1, 0.0, -1.0], [0.0, 0.1, -1.0], [-0.1, 0.0, -1.0], [0.0, 0.0, -1.0]])

    def loss(p):
        out = model.render_rays(p, ro, rd, key=None, train=False)
        return jnp.sum(out["rgb_fine"]) + jnp.sum(out["rgb_coarse"])

    g = jax.grad(loss)(params)
    for level in ("coarse", "fine"):
        leaves = jax.tree_util.tree_leaves(g[level])
        assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
        assert max(float(jnp.abs(x).max()) for x in leaves) > 0, level
