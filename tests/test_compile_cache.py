"""Placement of JAX's persistent compilation cache (utils/compile_cache)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from nerf_meets_mlx_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_repo_dot_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    assert path == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.configure_compile_cache() == tmp_path / "cc"
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the variable itself


def test_cache_dir_is_gitignored():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines or ".jax_cache" in lines


def test_package_import_sets_no_cache_dir():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax, nerf_meets_mlx_tpu, nerf_meets_mlx_tpu.entrypoints, "
        "nerf_meets_mlx_tpu.__main__; print(jax.config.jax_compilation_cache_dir)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None"
