"""Scalar metric logging to console + JSONL.

The reference's observability is a commented-out loss print and a matplotlib
panel every 50k iters (__test_nerf.py:296,308-322). Here every logged step
appends one JSON line (step, loss, psnr, steps/s, ...) to metrics.jsonl —
machine-readable history that survives restarts.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax


class MetricsLogger:
    def __init__(self, path: str | Path, echo: bool = True, enabled: bool = True):
        self.path = Path(path)
        self.enabled = enabled  # False on non-main hosts (process_index > 0)
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self.echo = echo

    def log(self, **metrics):
        if not self.enabled:
            return
        rec = {"ts": time.time(), **metrics}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.echo:
            parts = [
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            ]
            print("[train] " + " ".join(parts), file=sys.stderr)


def log_devices(tag: str) -> None:
    """Print the first device and the device count, so every run's log says
    what it ran on."""
    devs = jax.devices()
    print(
        f"[{tag}] device {devs[0]} ({devs[0].device_kind}), count {len(devs)}",
        flush=True,
    )
