"""Persistent XLA compilation cache placement.

Called by the program's entry points (``__main__.main``, ``bench.py``,
``chip_smoke.py``), never at package import, so importing the package (the
tests do) changes no JAX setting.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set here.
* Otherwise the cache lives at ``<repo>/.jax_cache``. The path is fixed (no
  pid, time or temp name) because it is part of the cache key: a directory
  that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
