"""Profiling / tracing hooks.

The reference has no profiling at all (SURVEY.md §5: only tqdm progress
bars). Here:

* ``trace(dir)`` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of device execution.
* ``timed(fn)`` — wall-clock timing of a jitted step, fenced with
  ``jax.block_until_ready``.
* ``Timer`` — rolling per-step rate tracker.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: ``with trace('/tmp/prof'): step(...)``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable, *args, n_warmup: int = 3, n_iters: int = 10) -> Tuple[float, object]:
    """Time `fn(*args)` with warmup; returns (seconds_per_call, last_output)."""
    out = None
    for _ in range(n_warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iters, out


class Timer:
    """Rolling steps/sec estimator."""

    def __init__(self):
        self._t = time.perf_counter()
        self._n = 0

    def tick(self, n: int = 1) -> float:
        self._n += n
        now = time.perf_counter()
        dt = now - self._t
        if dt <= 0:
            return 0.0
        rate = self._n / dt
        return rate

    def reset(self):
        self._t = time.perf_counter()
        self._n = 0
