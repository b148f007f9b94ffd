"""CP-decomposed low-rank grid encoding (TensoRF-style).

The Instant-NGP hash grid (encoding/hash_grid.py, reference WIP at
/root/reference/mlx_nerf/encoding/multi_hash.py) is built around random
table access. This encoding delivers the same capability class (a
fast-converging learned spatial encoding in front of a small MLP) with no
gathers. A CP (CANDECOMP/PARAFAC) factorization of the feature volume
[Chen et al. 2022, TensoRF] stores three 1-D factor lines per level:

    feat_c(x, y, z) = line_x[x, c] * line_y[y, c] * line_z[z, c]

and the 1-D linear interpolation of each line becomes a dense GEMM: the
interpolation weights along an axis form the hat matrix
``W[n, i] = max(0, 1 - |t_n - i|)`` (two nonzeros per row — exactly (1-f, f)
at floor/floor+1), so

    interp(line, t) = W @ line        # [N, R] @ [R, C] -> [N, C]

which is matrix-unit work instead of N row-gathers. The backward is two more
GEMMs (dW -> dt via the hat derivative; dline = W^T @ dout — the scatter-add
into the grid becomes a transposed matmul). XLA fuses the hat construction
into elementwise ops.

Cost: one level costs 2*R*C FLOPs/point/axis — at R=512, C=16, 3 axes that
is ~100 KFLOP/point.

Multi-resolution: L levels with geometric resolutions (like the hash grid's
Eq. 2-3) concatenate their per-level features -> out_dim = L * C.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.encoding.hash_grid import _level_resolutions


@dataclasses.dataclass(frozen=True)
class CPGridEncoding:
    in_dim: int = 3
    n_levels: int = 4
    min_res: int = 64
    max_res: int = 512
    n_components: int = 16       # CP rank per level
    init_scale: float = 0.2      # per-axis factor init std (product ~ scale^3)
    # world-space bounding box mapped to the unit cube (matches hash grid)
    bbox_min: float = -1.5
    bbox_max: float = 1.5
    # GEMM compute dtype for the hat-matrix interpolation. bf16 halves the
    # [N, R] operand's memory traffic; factors accumulate in f32.
    compute_dtype: str = "bfloat16"

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_components

    @property
    def resolutions(self) -> np.ndarray:
        return _level_resolutions(self.n_levels, self.min_res, self.max_res)

    def init_params(self, key: jax.Array) -> Dict[str, List[jnp.ndarray]]:
        """One [3, R_l, C] factor array per level (separate leaves — levels
        have different resolutions)."""
        lines = []
        for li, r in enumerate(self.resolutions):
            k = jax.random.fold_in(key, li)
            lines.append(
                self.init_scale
                * jax.random.normal(k, (3, int(r), self.n_components), jnp.float32)
            )
        return {"lines": lines}

    def apply(self, params: Dict[str, Any], x: jnp.ndarray) -> jnp.ndarray:
        """Encode world positions [..., 3] -> [..., L*C]."""
        assert self.in_dim == 3, "CP grid supports 3-D inputs"
        lead_shape = x.shape[:-1]
        x = x.reshape(-1, 3)
        u = (x - self.bbox_min) / (self.bbox_max - self.bbox_min)
        u = jnp.clip(u, 0.0, 1.0)
        cdt = jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32

        feats = []
        for li, r in enumerate(self.resolutions):
            r = int(r)
            lines = params["lines"][li]              # [3, R, C]
            t = u * (r - 1)                          # [N, 3], align-corners
            grid_i = jnp.arange(r, dtype=jnp.float32)
            level = None
            for axis in range(3):
                # hat-function interpolation weights: two nonzeros per row
                W = jax.nn.relu(1.0 - jnp.abs(t[:, axis : axis + 1] - grid_i[None, :]))
                f = jnp.dot(
                    W.astype(cdt),
                    lines[axis].astype(cdt),
                    preferred_element_type=jnp.float32,
                )                                    # [N, C]
                level = f if level is None else level * f
            feats.append(level)
        return jnp.concatenate(feats, axis=-1).reshape(*lead_shape, self.out_dim)
