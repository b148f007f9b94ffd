"""bench.py harness smoke test (CPU, tiny batch)."""

import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench


def test_bench_setup_and_step_runs():
    step, state, images, poses, n_rand = bench.make_bench_setup(n_rand=64)
    assert n_rand == 64
    key = jax.random.PRNGKey(0)
    state, aux = step(state, images, poses, key)
    assert np.isfinite(float(aux["loss"]))
    assert int(state.step) == 1
