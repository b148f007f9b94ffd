"""One tiny train step for every preset in PRESETS, on the plain path, and
the placement of the training images on a multi-device mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_meets_mlx_tpu.config import PRESETS, MLPConfig
from nerf_meets_mlx_tpu.datasets import make_synthetic_scene
from nerf_meets_mlx_tpu.datasets.image import make_test_image, pixel_dataset
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.engine.trainer import make_image_train_step, make_nerf_train_step
from nerf_meets_mlx_tpu.models import create_nerf


def _tiny(cfg):
    def shrink(m):
        if m is None:
            return None
        return MLPConfig(
            net_depth=min(m.net_depth, 3), net_width=16,
            skips=tuple(s for s in m.skips if s < 2), use_viewdirs=m.use_viewdirs,
            out_channels=m.out_channels,
        )

    pe = cfg.pos_encoding
    if pe.kind == "hash_grid":
        pe = dataclasses.replace(pe, hash_log2_table_size=8)
    if pe.kind == "cp_grid":
        pe = dataclasses.replace(pe, cp_max_res=32, cp_min_res=8)
    render = cfg.render
    if render.n_samples:
        render = dataclasses.replace(
            render, n_samples=6, n_importance=4 if render.n_importance else 0,
            occ_resolution=8, occ_update_every=1, occ_warmup=0,
        )
    return cfg.replace(
        pos_encoding=pe, mlp=shrink(cfg.mlp), mlp_fine=shrink(cfg.mlp_fine),
        render=render, train=dataclasses.replace(cfg.train, n_rand=32, precrop_iters=0),
    )


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_one_tiny_train_step_per_preset(name):
    cfg = _tiny(PRESETS[name]())
    model = create_nerf(cfg)
    key = jax.random.PRNGKey(0)
    if cfg.data.dataset_type == "image":
        step = make_image_train_step(model)
        coords, colors = pixel_dataset(make_test_image(16))
        args = (jnp.asarray(coords), jnp.asarray(colors))
        occ = None
    else:
        ds = make_synthetic_scene(2, 1, 1, 12, white_bkgd=cfg.render.white_bkgd)
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        args = (jnp.asarray(ds.images[ds.i_train]), jnp.asarray(ds.poses[ds.i_train, :3, :4]))
        occ = None
        if cfg.render.occupancy:
            from nerf_meets_mlx_tpu.acceleration.occupancy import init_occupancy_grid

            occ = init_occupancy_grid(cfg.render.occ_resolution)
    state = create_train_state(model.init(jax.random.PRNGKey(1)), cfg.train, occ_grid=occ)
    before = jax.tree_util.tree_map(np.asarray, state.params)
    state, aux = step(state, *args, key)
    assert int(state.step) == 1
    assert np.isfinite(float(aux["loss"])) and np.isfinite(float(aux["psnr"]))
    moved = [
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(state.params))
    ]
    assert any(moved)
    if occ is not None:
        assert float(jnp.abs(state.occ_grid).max()) > 0.0  # refreshed at step 0


def test_sharded_train_replicates_images_on_the_mesh(tmp_path, monkeypatch):
    """The sharded train entry point places the image set on every device of
    the mesh, not on device 0 alone (where each step would copy it out)."""
    import importlib

    mod = importlib.import_module("nerf_meets_mlx_tpu.entrypoints.train_nerf")
    seen = {}

    class Spy(mod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["args"] = self.step_args

    monkeypatch.setattr(mod, "Trainer", Spy)
    mod.train_nerf(
        preset="lego_fast", log_dir=tmp_path / "logs", render_video=False,
        synth_resolution=8, max_iters=1,
    )
    images, poses = seen["args"]
    n = len(jax.devices())
    assert n > 1
    for arr in (images, poses):
        assert len(arr.sharding.device_set) == n
        assert arr.sharding.is_fully_replicated
