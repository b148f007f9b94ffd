"""Multi-device data parallelism on the 8-way virtual CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import lego_hierarchical
from nerf_meets_mlx_tpu.datasets import make_synthetic_scene
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.engine.trainer import make_nerf_train_step
from nerf_meets_mlx_tpu.models import create_nerf
from nerf_meets_mlx_tpu.parallel import (
    make_mesh,
    make_sharded_nerf_train_step,
    make_sharded_render_image,
    replicate_state,
    data_sharding,
)


def _tiny_cfg(n_rand=256):
    cfg = lego_hierarchical()
    return cfg.replace(
        mlp=dataclasses.replace(cfg.mlp, net_depth=2, net_width=32, skips=()),
        mlp_fine=dataclasses.replace(cfg.mlp, net_depth=2, net_width=32, skips=()),
        render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8),
        train=dataclasses.replace(cfg.train, n_rand=n_rand),
    )


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data",)


def test_sharded_step_runs_and_shards_rays():
    cfg = _tiny_cfg(n_rand=256)
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=2, n_val=1, n_test=1, resolution=16)
    mesh = make_mesh()
    step = make_sharded_nerf_train_step(model, ds.H, ds.W, ds.focal, mesh)
    state = replicate_state(
        create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train), mesh
    )
    images = jax.device_put(jnp.asarray(ds.images[ds.i_train]))
    poses = jax.device_put(jnp.asarray(ds.poses[ds.i_train, :3, :4]))
    state, aux = step(state, images, poses, jax.random.PRNGKey(1))
    assert np.isfinite(float(aux["loss"]))
    assert int(state.step) == 1
    # params remain replicated after the update
    w = state.params["coarse"]["pos_linears"][0]["w"]
    assert w.sharding.is_fully_replicated


def test_sharded_matches_single_device():
    """Same keys, same data -> sharded step computes the same update as the
    unsharded step (all-reduce correctness)."""
    cfg = _tiny_cfg(n_rand=128)
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=2, n_val=1, n_test=1, resolution=16)
    mesh = make_mesh()

    images = jnp.asarray(ds.images[ds.i_train])
    poses = jnp.asarray(ds.poses[ds.i_train, :3, :4])
    key = jax.random.PRNGKey(3)

    # init twice from the same key: the steps donate their input state, so
    # the first call would invalidate a shared params pytree
    single = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    s1 = create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train)
    s1, aux1 = single(s1, images, poses, key)

    sharded = make_sharded_nerf_train_step(model, ds.H, ds.W, ds.focal, mesh)
    s2 = replicate_state(
        create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train), mesh
    )
    s2, aux2 = sharded(s2, images, poses, key)

    np.testing.assert_allclose(float(aux1["loss"]), float(aux2["loss"]), rtol=1e-4)
    w1 = np.asarray(s1.params["coarse"]["pos_linears"][0]["w"])
    w2 = np.asarray(s2.params["coarse"]["pos_linears"][0]["w"])
    np.testing.assert_allclose(w1, w2, rtol=1e-4, atol=1e-6)


def test_weak_scaling_batch():
    cfg = _tiny_cfg()
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=2, n_val=1, n_test=1, resolution=16)
    mesh = make_mesh()
    step = make_sharded_nerf_train_step(
        model, ds.H, ds.W, ds.focal, mesh, n_rand_per_device=64
    )
    state = replicate_state(
        create_train_state(model.init(jax.random.PRNGKey(0)), cfg.train), mesh
    )
    state, aux = step(
        state,
        jnp.asarray(ds.images[ds.i_train]),
        jnp.asarray(ds.poses[ds.i_train, :3, :4]),
        jax.random.PRNGKey(1),
    )
    assert np.isfinite(float(aux["loss"]))


def test_indivisible_batch_raises():
    cfg = _tiny_cfg(n_rand=100)  # not divisible by 8
    model = create_nerf(cfg)
    mesh = make_mesh()
    try:
        make_sharded_nerf_train_step(model, 16, 16, 10.0, mesh)
    except ValueError as e:
        assert "divisible" in str(e)
    else:
        raise AssertionError("expected ValueError")


def test_data_sharding_layout():
    mesh = make_mesh()
    x = jnp.zeros((16, 3))
    xs = jax.device_put(x, data_sharding(mesh))
    # each device holds 2 rows
    shard_shapes = {s.data.shape for s in xs.addressable_shards}
    assert shard_shapes == {(2, 3)}


def test_sharded_render_matches_single_device():
    """Sharded full-frame eval == single-device render_image (pixel shards
    change the partitioning, not the math)."""
    from nerf_meets_mlx_tpu.rendering import render_image

    cfg = _tiny_cfg()
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=2, n_val=1, n_test=1, resolution=16)
    mesh = make_mesh()
    params = model.init(jax.random.PRNGKey(0))
    c2w = ds.poses[0, :3, :4]

    from nerf_meets_mlx_tpu.parallel import replicated

    ref = render_image(model, params, ds.H, ds.W, ds.K, c2w, chunk=64)
    render_sharded = make_sharded_render_image(model, mesh, chunk=64)
    params_repl = jax.device_put(params, replicated(mesh))
    out = render_sharded(params_repl, ds.H, ds.W, ds.K, c2w)
    for k in ("rgb_map", "disp_map", "acc_map", "depth_map"):
        np.testing.assert_allclose(
            np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6
        )
    assert out["rgb_map"].shape == (ds.H, ds.W, 3)


def test_sharded_render_ndc_path():
    """NDC render goes through the same sharded program (llff-style cfg)."""
    cfg = _tiny_cfg()
    cfg = cfg.replace(
        render=dataclasses.replace(cfg.render, ndc=True, near=0.0, far=1.0)
    )
    model = create_nerf(cfg)
    ds = make_synthetic_scene(n_train=2, n_val=1, n_test=1, resolution=16)
    mesh = make_mesh()
    params = model.init(jax.random.PRNGKey(0))
    render_sharded = make_sharded_render_image(model, mesh, chunk=64)
    out = render_sharded(params, ds.H, ds.W, ds.K, ds.poses[0, :3, :4])
    assert np.isfinite(np.asarray(out["rgb_map"])).all()
