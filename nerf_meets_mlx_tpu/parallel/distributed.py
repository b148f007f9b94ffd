"""Multi-host initialization.

The reference has no distributed layer (SURVEY.md §2 checklist). Here the
multi-host story is deliberately thin because the single-controller JAX
model does the heavy lifting:

1. every host calls ``init_distributed()`` (jax.distributed.initialize —
   coordinator discovery via env or explicit args),
2. ``make_mesh()`` then spans ALL processes' devices; the same
   ``make_sharded_nerf_train_step`` runs unchanged — rays shard globally
   and the gradient all-reduce spans every device,
3. host-local input loading: each process feeds only its addressable shard
   of the ray batch (``host_local_batch``),
4. ``is_main_process()`` gates logging/checkpoint writes.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# env vars whose presence means "a multi-process run was CONFIGURED":
# jax.distributed reads these when initialize() gets no explicit args
_COORD_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
)

# env vars that carry a PROCESS COUNT under cluster schedulers whose jax
# cluster plugins auto-discover the coordinator (SLURM, Open MPI). Presence
# alone is not enough — e.g. SLURM sets SLURM_NTASKS=1 for a
# plain salloc shell — so these only count when they parse to > 1.
_PROC_COUNT_ENV_VARS = (
    "SLURM_NTASKS",          # jax SlurmCluster
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",  # jax OmpiCluster
)


def _multiprocess_configured() -> bool:
    if any(os.environ.get(v) for v in _COORD_ENV_VARS):
        return True
    for v in _PROC_COUNT_ENV_VARS:
        raw = os.environ.get(v, "")
        if not raw:
            continue
        try:
            if int(raw) > 1:
                return True
        except ValueError:
            continue
    return False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX. No-op when running single-process or when
    already initialized. Under a cluster scheduler jax knows (SLURM, Open
    MPI) all args auto-discover; elsewhere pass them explicitly.

    Failure policy: if a multi-process run IS configured (explicit args or
    coordinator env vars) and initialization fails, this RAISES — degrading
    silently would leave N hosts each believing it is process 0, training N
    independent models into the same log/checkpoint dir. The silent
    fallback only covers the genuinely-unconfigured single-process case.
    """
    # NB: must not call jax.process_count()/jax.devices() here — touching
    # the backend initializes it, after which jax.distributed.initialize
    # refuses to run ("must be called before any JAX computations")
    if jax.distributed.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    try:
        if not explicit:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    except (ValueError, RuntimeError) as e:
        if explicit or _multiprocess_configured():
            raise RuntimeError(
                "jax.distributed.initialize failed although a multi-process "
                "run is configured (explicit args or coordinator env vars); "
                "refusing to continue single-process"
            ) from e
        # no multi-process configuration anywhere — single-process run


def is_main_process() -> bool:
    return jax.process_index() == 0


def host_local_batch(global_batch: int) -> int:
    """Per-host slice of a global ray batch (host-sharded data loading)."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n
