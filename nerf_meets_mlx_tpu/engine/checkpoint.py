"""Checkpoint save/restore: the flattened TrainState in one ``.npz``.

The reference flags checkpointing but never implements it — `--no_reload`,
`--ft_path`, `--i_weights` exist (config_parser.py:25-26,75) while
create_NeRF holds only `# TODO: load state here` (models/NeRF.py:122-125)
and update_NeRF_args even forces no_reload=True (config_parser.py:120).
Here the full TrainState (params, Adam moments, step, occupancy grid)
round-trips losslessly.

Layout: ``<ckpt_dir>/step_<8 digits>/state.npz``, one array per pytree leaf,
keyed by its path (``jax.tree_util.keystr``). A save is written under a
temporary name and renamed into place, so ``latest_step`` never sees a
half-written checkpoint. Restore checks the stored keys, shapes and dtypes
against the template and refuses a mismatch.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np
from jax.experimental import multihost_utils

_STEP_DIR = re.compile(r"step_(\d{8})")
_STATE_FILE = "state.npz"


def _ckpt_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step_{step:08d}"


def _host_leaf(x) -> np.ndarray:
    # a state replicated over a multi-process mesh is not fully addressable;
    # every local shard holds the whole (replicated) value
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return np.asarray(x.addressable_data(0))
    return np.asarray(x)


def _flatten(tree: Any) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}


def save_checkpoint(ckpt_dir: str | Path, state: Any, step: int) -> Path:
    """Multi-process contract: called by EVERY process; process 0 writes,
    then all processes meet at a barrier so none runs ahead of the save."""
    path = _ckpt_path(ckpt_dir, step)
    if jax.process_index() == 0:
        arrays = {k: _host_leaf(v) for k, v in _flatten(state).items()}
        tmp = path.with_name(path.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(tmp / _STATE_FILE, **arrays)
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(f"checkpoint_{step}")
    return path


def restore_checkpoint(ckpt_dir: str | Path, template: Any, step: int) -> Any:
    """Restore into the structure of `template`: the stored keys, shapes and
    dtypes must match it exactly. Leaves come back as host numpy arrays."""
    wanted = _flatten(template)
    path = _ckpt_path(ckpt_dir, step) / _STATE_FILE
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    if set(stored) != set(wanted):
        missing = sorted(set(wanted) - set(stored))
        extra = sorted(set(stored) - set(wanted))
        raise ValueError(
            f"checkpoint {path} does not match the train state: "
            f"missing {missing[:5]}, unexpected {extra[:5]}"
        )
    leaves = []
    for key, ref in wanted.items():
        arr = stored[key]
        dtype = np.dtype(ref.dtype)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == dtype.itemsize:
            arr = arr.view(dtype)  # numpy stores bfloat16 as raw bytes
        if arr.shape != tuple(ref.shape) or arr.dtype != dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {arr.dtype}{list(arr.shape)}, "
                f"the train state wants {dtype}{list(ref.shape)}"
            )
        leaves.append(arr)
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """Largest step with a complete save (unfinished ``.tmp`` saves and
    directories without a state file are skipped)."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = [
        int(m.group(1))
        for p in d.iterdir()
        if (m := _STEP_DIR.fullmatch(p.name)) and (p / _STATE_FILE).is_file()
    ]
    return max(steps) if steps else None
