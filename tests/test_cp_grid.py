"""CP low-rank grid encoding (encoding/cp_grid.py): hat-matrix interpolation
correctness vs a direct numpy gather implementation, gradient flow, and
end-to-end training (the CP-grid counterpart of BASELINE config 5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import EncodingConfig, lego_cp
from nerf_meets_mlx_tpu.datasets import make_synthetic_scene
from nerf_meets_mlx_tpu.encoding.base import make_encoding
from nerf_meets_mlx_tpu.encoding.cp_grid import CPGridEncoding
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.engine.trainer import make_nerf_train_step
from nerf_meets_mlx_tpu.models import create_nerf


def _enc(**kw):
    defaults = dict(
        n_levels=2, min_res=8, max_res=16, n_components=4,
        bbox_min=-1.0, bbox_max=1.0, compute_dtype="float32",
    )
    defaults.update(kw)
    return CPGridEncoding(**defaults)


def _numpy_reference(enc: CPGridEncoding, params, x):
    """Direct gather + lerp transcription of the CP feature definition."""
    u = np.clip((np.asarray(x) - enc.bbox_min) / (enc.bbox_max - enc.bbox_min), 0, 1)
    outs = []
    for li, r in enumerate(enc.resolutions):
        r = int(r)
        lines = np.asarray(params["lines"][li])  # [3, R, C]
        t = u * (r - 1)
        i0 = np.clip(np.floor(t).astype(int), 0, r - 2)
        f = t - i0
        level = np.ones((x.shape[0], enc.n_components), np.float32)
        for a in range(3):
            v = lines[a][i0[:, a]] * (1 - f[:, a : a + 1]) + lines[a][
                i0[:, a] + 1
            ] * f[:, a : a + 1]
            level = level * v
        outs.append(level)
    return np.concatenate(outs, axis=-1)


def test_matches_gather_reference():
    enc = _enc()
    params = enc.init_params(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (64, 3), minval=-1.0, maxval=1.0)
    got = np.asarray(enc.apply(params, x))
    want = _numpy_reference(enc, params, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_exact_at_grid_nodes():
    """At a grid node the hat weight is exactly 1 there and 0 elsewhere."""
    enc = _enc(n_levels=1, min_res=8, max_res=8)
    params = enc.init_params(jax.random.PRNGKey(0))
    lines = params["lines"][0]  # [3, 8, C]
    # node index 3 along each axis -> u = 3/7 -> world = -1 + 2*3/7
    w = -1.0 + 2.0 * 3.0 / 7.0
    x = jnp.asarray([[w, w, w]])
    got = np.asarray(enc.apply(params, x))[0]
    want = np.asarray(lines[0, 3] * lines[1, 3] * lines[2, 3])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_continuity_across_cells():
    enc = _enc(n_levels=1, min_res=16, max_res=16)
    params = enc.init_params(jax.random.PRNGKey(0))
    eps = 1e-4
    # straddle the cell boundary at u=0.5 (t=7.5 of 15 -> interior)
    a = enc.apply(params, jnp.asarray([[0.0 - eps, 0.1, 0.2]]))
    b = enc.apply(params, jnp.asarray([[0.0 + eps, 0.1, 0.2]]))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-2)


def test_gradients_flow_to_lines():
    enc = _enc()
    params = enc.init_params(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (32, 3), minval=-0.9, maxval=0.9)

    def loss(p):
        return jnp.sum(enc.apply(p, x) ** 2)

    g = jax.grad(loss)(params)
    total = sum(float(jnp.abs(gl).sum()) for gl in g["lines"])
    assert total > 0.0


def test_out_dim_and_dispatch():
    cfg = EncodingConfig(kind="cp_grid", cp_n_levels=3, cp_n_components=8)
    enc = make_encoding(cfg)
    assert cfg.out_dim == 24 and enc.out_dim == 24
    params = enc.init_params(jax.random.PRNGKey(0))
    y = enc.apply(params, jnp.zeros((5, 2, 3)))
    assert y.shape == (5, 2, 24)


def _tiny_cp():
    cfg = lego_cp()
    pos = dataclasses.replace(
        cfg.pos_encoding, cp_n_levels=2, cp_min_res=8, cp_max_res=32,
        cp_n_components=8,
    )
    return cfg.replace(
        pos_encoding=pos,
        render=dataclasses.replace(cfg.render, n_samples=16, n_importance=16),
        train=dataclasses.replace(cfg.train, n_rand=256, lrate=5e-3),
    )


def test_cp_trains_and_lines_update():
    cfg = _tiny_cp()
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=4, n_val=1, n_test=1, resolution=32)
    images = jnp.asarray(ds.images[ds.i_train])
    poses = jnp.asarray(ds.poses[ds.i_train, :3, :4])
    step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    state = create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train)
    l0 = np.asarray(state.params["pos_enc"]["lines"][0]).copy()
    key = jax.random.PRNGKey(1)
    first = None
    for i in range(100):
        state, aux = step(state, images, poses, key)
        if i == 0:
            first = float(aux["loss"])
    last = float(aux["loss"])
    assert np.isfinite(last) and last < first
    l1 = np.asarray(state.params["pos_enc"]["lines"][0])
    assert np.abs(l1 - l0).max() > 1e-5, "factor lines did not receive gradients"
