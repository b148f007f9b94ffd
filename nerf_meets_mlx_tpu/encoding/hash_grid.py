"""Instant-NGP multiresolution hash-grid encoding (Müller et al. 2022).

Redesign of the reference's WIP MultiHashEncoding
(/root/reference/mlx_nerf/encoding/multi_hash.py:13-137). The reference is
broken as written — it calls a Python *list* of nn.Embeddings as a function
(multi_hash.py:112-119) and uses ceil/floor corners that degenerate when the
scaled coordinate is integral (SURVEY.md §2.9). This implementation:

* keeps all L hash tables in ONE [L, T, F] parameter array — a single pytree
  leaf that checkpoints/shards/all-reduces like any other parameter,
* uses floor / floor+1 corner pairs (never degenerate),
* hashes with the reference's Lehmer primes (multi_hash.py:66-70:
  PRIME1=1 "for cache coherence", 2654435761, 805459861) but reduces with a
  power-of-two bitmask instead of ``%``,
* computes the 8-corner trilinear interpolation as one batched gather +
  weighted sum — XLA turns the backward into a scatter-add into the tables.

Geometric level growth b = exp((ln N_max - ln N_min)/(L-1)) and per-level
resolutions N_l = floor(N_min * b**l) follow Eq. (2-3) of the paper
(mirrored at multi_hash.py:35-40).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# Lehmer-style hash primes (multi_hash.py:66-70)
_PRIMES = (1, 2654435761, 805459861)


def _level_resolutions(n_levels: int, min_res: int, max_res: int) -> np.ndarray:
    if n_levels > 1:
        b = np.exp((np.log(max_res) - np.log(min_res)) / (n_levels - 1))
    else:
        b = 1.0
    return np.floor(min_res * b ** np.arange(n_levels)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class HashGridEncoding:
    in_dim: int = 3
    n_levels: int = 16
    min_res: int = 16
    max_res: int = 512
    features_per_level: int = 2
    log2_table_size: int = 19
    init_scale: float = 1e-4
    # world-space bounding box mapped to the unit cube before hashing
    bbox_min: float = -1.5
    bbox_max: float = 1.5

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    def init_params(self, key: jax.Array):
        # U(-init_scale, init_scale), per the paper's init (multi_hash.py:50-51)
        tables = jax.random.uniform(
            key,
            (self.n_levels, self.table_size, self.features_per_level),
            minval=-self.init_scale,
            maxval=self.init_scale,
            dtype=jnp.float32,
        )
        return {"tables": tables}

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        """Encode world positions [..., 3] -> [..., L*F]."""
        assert self.in_dim == 3, "hash grid currently supports 3-D inputs"
        tables = params["tables"]  # [L, T, F]
        lead_shape = x.shape[:-1]
        x = x.reshape(-1, 3)

        # normalize to the unit cube
        u = (x - self.bbox_min) / (self.bbox_max - self.bbox_min)
        u = jnp.clip(u, 0.0, 1.0)

        res = jnp.asarray(
            _level_resolutions(self.n_levels, self.min_res, self.max_res),
            dtype=jnp.float32,
        )  # [L]
        scaled = u[:, None, :] * res[None, :, None]  # [N, L, 3]
        floor = jnp.floor(scaled)
        frac = scaled - floor  # [N, L, 3]
        base = floor.astype(jnp.uint32)
        level_idx = jnp.arange(self.n_levels, dtype=jnp.int32)[None, :]  # [1, L]
        mask = jnp.uint32(self.table_size - 1)

        # Static loop over the 8 corners (bit c = (bz, by, bx)). Keeping the
        # corner axis OUT of the arrays bounds peak memory at [N, L(,F)]
        # buffers — the naive [N, L, 8, 3] weight cube materializes ~19 GB
        # at the fine batch (786k pts x 16 levels) and exhausts device memory.
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]  # [N, L]
        feats = jnp.zeros(
            (x.shape[0], self.n_levels, self.features_per_level), jnp.float32
        )
        for c in range(8):
            bx, by, bz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            # XOR-product hash in uint32 (primes exceed int32; wrap-around
            # is the intended modular arithmetic), bitmasked to table size
            h = (
                (base[..., 0] + jnp.uint32(bx)) * jnp.uint32(_PRIMES[0])
                ^ (base[..., 1] + jnp.uint32(by)) * jnp.uint32(_PRIMES[1])
                ^ (base[..., 2] + jnp.uint32(bz)) * jnp.uint32(_PRIMES[2])
            ) & mask  # [N, L]
            g = tables[level_idx, h.astype(jnp.int32)]  # [N, L, F]
            w = (
                (fx if bx else 1.0 - fx)
                * (fy if by else 1.0 - fy)
                * (fz if bz else 1.0 - fz)
            )  # [N, L]
            feats = feats + g * w[..., None]
        return feats.reshape(*lead_shape, self.out_dim)
