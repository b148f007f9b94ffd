"""The .npz checkpoint: round trip, structure check, unfinished saves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_meets_mlx_tpu.engine.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from nerf_meets_mlx_tpu.engine.train_state import create_train_state
from nerf_meets_mlx_tpu.config import TrainConfig


def _state(width=8, occ=True, bf16=False):
    params = {
        "coarse": {"w": jnp.arange(3 * width, dtype=jnp.float32).reshape(3, width)},
        "pos_enc": {"tables": jnp.ones((2, 4, 2), jnp.bfloat16 if bf16 else jnp.float32)},
    }
    grid = jnp.full((4, 4, 4), 0.5, jnp.float32) if occ else None
    return create_train_state(params, TrainConfig(), occ_grid=grid).replace(
        step=jnp.asarray(12, jnp.int32)
    )


def test_roundtrip_is_lossless(tmp_path):
    state = _state(bf16=True)
    path = save_checkpoint(tmp_path / "ckpt", state, 12)
    assert path.name == "step_00000012" and (path / "state.npz").is_file()
    assert latest_step(tmp_path / "ckpt") == 12
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    back = restore_checkpoint(tmp_path / "ckpt", template, 12)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "template_kw", [{"occ": False}, {"width": 9}], ids=["missing-leaf", "shape"]
)
def test_restore_rejects_a_mismatched_structure(tmp_path, template_kw):
    save_checkpoint(tmp_path / "ckpt", _state(), 3)
    with pytest.raises(ValueError, match="checkpoint"):
        restore_checkpoint(tmp_path / "ckpt", _state(**template_kw), 3)


def test_unfinished_saves_are_skipped(tmp_path):
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, _state(), 5)
    # a save killed before its rename, and a directory with no state file
    (ckpt / "step_00000009.tmp").mkdir()
    (ckpt / "step_00000009.tmp" / "state.npz").write_bytes(b"partial")
    (ckpt / "step_00000007").mkdir()
    assert latest_step(ckpt) == 5
    # a later save of the same step replaces a stale temp directory
    save_checkpoint(ckpt, _state(), 9)
    assert latest_step(ckpt) == 9
    assert not (ckpt / "step_00000009.tmp").exists()
