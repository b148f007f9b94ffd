"""nerf_meets_mlx_tpu — a NeRF training & rendering framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
`piljoong-jeong/nerf_meets_mlx` reference (mounted at /root/reference):

* 2-D image learning (MLP + sinusoidal encoding overfits an RGB image).
* Hierarchical coarse/fine NeRF volume learning on Blender-synthetic scenes
  with detached (stop-gradient) importance sampling.
* Sinusoidal / identity / spherical-harmonics / Instant-NGP multigrid hash
  / CP low-rank grid encodings.

Architecture:

* functional param pytrees + pure apply fns (jit/grad/vmap-transformable),
* a single fused train step (coarse fwd+bwd, on-device inverse-CDF
  resampling under stop_gradient, fine fwd+bwd) — no host round-trips,
* rays sharded over a `jax.sharding.Mesh` data axis, params replicated,
  gradient all-reduce over the mesh,
* ``.npz`` checkpointing, JSONL metrics, typed dataclass configs.
"""

from nerf_meets_mlx_tpu.version import __version__

__all__ = ["__version__"]
