"""Device-mesh helpers.

The reference is strictly single-device (mx.set_default_device(mx.gpu),
/root/reference/mlx_nerf/__main__.py:14; no distributed code anywhere —
SURVEY.md §2 parallelism checklist). The scaling story:

* ONE flat mesh axis, ``data``: rays are embarrassingly parallel, so the ray
  batch shards across all devices while MLP weights and hash tables
  replicate, and the gradients of the replicated params all-reduce.
* The per-ray depth axis (64/192 samples — the workload's "sequence") never
  leaves a device: the compositing scan is local, so no ring/Ulysses-style
  exchange exists. Tensor/pipeline parallelism are deliberate non-goals: a
  W=256 MLP fits on one device many times over.

Multi-host: call `jax.distributed.initialize()` before `make_mesh()`; the
mesh then spans all processes' devices and the same code runs unchanged.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.8: core API, replication-check kwarg is `check_vma`
    from jax import shard_map as _shard_map

    _SM_CHECK_KWARG = "check_vma"
except ImportError:  # pragma: no cover — pre-0.8 experimental API: `check_rep`
    from jax.experimental.shard_map import shard_map as _shard_map

    _SM_CHECK_KWARG = "check_rep"


def shard_map_nocheck(f, mesh: Mesh, in_specs, out_specs):
    """shard_map with the replication check disabled, passing whichever
    kwarg (check_vma / check_rep) the installed jax expects — the old API
    would TypeError on check_vma (ADVICE r2)."""
    return _shard_map(
        f,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        **{_SM_CHECK_KWARG: False},
    )


def make_mesh(n_devices: int = 0, axis: str = "data") -> Mesh:
    """1-D mesh over the first `n_devices` devices (0 = all visible)."""
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard dim 0 over the data axis (ray/pixel batches)."""
    return NamedSharding(mesh, P(axis))
