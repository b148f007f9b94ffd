"""Encoding abstraction.

Functional counterpart of the reference's ``Encoding(nn.Module)`` hierarchy
(/root/reference/mlx_nerf/encoding/__init__.py:10-23). An encoding here is a
stateless object exposing

  * ``out_dim``            — static output feature width,
  * ``init_params(key)``   — a (possibly empty) parameter pytree,
  * ``apply(params, x)``   — pure function, jit/vmap/grad-safe.

Learned encodings (the Instant-NGP hash grid) carry their tables in
``params`` so they flow through optax/checkpointing/sharding like any other
parameters — the reference instead held mlx ``nn.Embedding`` modules
(multi_hash.py:46-51).
"""

from __future__ import annotations

from typing import Any, Protocol

import jax

from nerf_meets_mlx_tpu.config import EncodingConfig


class Encoding(Protocol):
    out_dim: int

    def init_params(self, key: jax.Array) -> Any: ...

    def apply(self, params: Any, x: jax.Array) -> jax.Array: ...


def make_encoding(cfg: EncodingConfig) -> "Encoding":
    """Build an encoding from config (dispatch on ``cfg.kind``)."""
    from nerf_meets_mlx_tpu.encoding.identity import IdentityEncoding
    from nerf_meets_mlx_tpu.encoding.sinusoidal import SinusoidalEncoding
    from nerf_meets_mlx_tpu.encoding.spherical_harmonics import (
        SphericalHarmonicsEncoding,
    )
    from nerf_meets_mlx_tpu.encoding.hash_grid import HashGridEncoding

    if cfg.kind == "identity":
        return IdentityEncoding(cfg.in_dim)
    if cfg.kind == "sinusoidal":
        return SinusoidalEncoding(
            in_dim=cfg.in_dim,
            n_freqs=cfg.n_freqs,
            min_freq_exp=cfg.min_freq_exp,
            max_freq_exp=cfg.max_freq_exp,
            include_input=cfg.include_input,
            band_mode=cfg.frequency_bands,
        )
    if cfg.kind == "spherical_harmonics":
        return SphericalHarmonicsEncoding(cfg.in_dim, cfg.sh_degree)
    if cfg.kind == "hash_grid":
        return HashGridEncoding(
            in_dim=cfg.in_dim,
            n_levels=cfg.hash_n_levels,
            min_res=cfg.hash_min_res,
            max_res=cfg.hash_max_res,
            features_per_level=cfg.hash_features_per_level,
            log2_table_size=cfg.hash_log2_table_size,
            init_scale=cfg.hash_init_scale,
        )
    if cfg.kind == "cp_grid":
        from nerf_meets_mlx_tpu.encoding.cp_grid import CPGridEncoding

        return CPGridEncoding(
            in_dim=cfg.in_dim,
            n_levels=cfg.cp_n_levels,
            min_res=cfg.cp_min_res,
            max_res=cfg.cp_max_res,
            n_components=cfg.cp_n_components,
            init_scale=cfg.cp_init_scale,
        )
    raise ValueError(f"unknown encoding kind: {cfg.kind}")
