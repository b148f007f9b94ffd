"""Model assembly: encodings + coarse/fine MLPs + the hierarchical
ray-rendering pipeline as one pure function.

Replaces the reference's ``create_NeRF`` kwargs-dict plumbing
(/root/reference/mlx_nerf/models/NeRF.py:51-158) — which packed networks,
query closures and render flags into mutable dicts (with the train/test
aliasing bug at NeRF.py:151-156) — with an immutable ``NeRFModel`` whose
``render_rays`` is a single jit-able function:

    coarse stratified pass -> compositor -> stop-gradient inverse-CDF
    importance resampling -> fine pass -> compositor

Crucially the coarse weights feeding the sampler come from the SAME forward
used for the coarse loss, eliminating the reference's duplicated uncompiled
coarse forward (__test_nerf.py:253-270) and its torch-CPU searchsorted
round-trip (__test_nerf.py:274-285).

There is no netchunk-style inner batching (NeRF.py:10-22): under jit the
whole [B*S, C] point batch is one GEMM chain; memory tiling for huge eval
renders happens at the ray level via lax.map (rendering/renderer.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from nerf_meets_mlx_tpu.config import ExperimentConfig
from nerf_meets_mlx_tpu.encoding.base import Encoding, make_encoding
from nerf_meets_mlx_tpu.models.nerf_mlp import init_nerf_mlp, nerf_mlp_apply
from nerf_meets_mlx_tpu.rendering.volume import raw2outputs
from nerf_meets_mlx_tpu.sampling.stratified import (
    sample_z_uniform,
    sample_z_lindisp,
    stratified_jitter,
)
from nerf_meets_mlx_tpu.sampling.importance import merge_z, sample_pdf, shard_rand

Params = Dict[str, Any]


# shard-invariant RNG lives with the sampling utilities; alias kept for the
# call sites below (draws at the GLOBAL batch shape, slices the local shard)
_shard_rand = shard_rand


@dataclasses.dataclass(frozen=True)
class NeRFModel:
    """Static model description; all state lives in the params pytree."""

    cfg: ExperimentConfig
    pos_enc: Encoding
    dir_enc: Optional[Encoding]

    # -- init ---------------------------------------------------------------

    def init(self, key: jax.Array) -> Params:
        k_coarse, k_fine, k_penc, k_denc = jax.random.split(key, 4)
        dir_dim = self.dir_enc.out_dim if self.dir_enc is not None else 0
        params: Params = {
            "coarse": init_nerf_mlp(
                k_coarse, self.cfg.mlp, self.pos_enc.out_dim, dir_dim
            ),
            "pos_enc": self.pos_enc.init_params(k_penc),
            "dir_enc": self.dir_enc.init_params(k_denc) if self.dir_enc else {},
        }
        if self.cfg.mlp_fine is not None:
            params["fine"] = init_nerf_mlp(
                k_fine, self.cfg.mlp_fine, self.pos_enc.out_dim, dir_dim
            )
        return params

    # -- point query --------------------------------------------------------

    def query(
        self,
        params: Params,
        level: str,                  # "coarse" | "fine"
        pts: jnp.ndarray,            # [B, S, 3]
        viewdirs: Optional[jnp.ndarray],  # [B, 3] normalized
    ) -> jnp.ndarray:
        """Encode points (+dirs broadcast per sample) and run the MLP.

        Equivalent of run_model/embed (NeRF.py:25-48, embedding.py:4-21)
        without host chunking."""
        mlp_cfg = self.cfg.mlp if level == "coarse" else (self.cfg.mlp_fine or self.cfg.mlp)
        mlp_params = params[level] if level in params else params["coarse"]

        x_pos = self.pos_enc.apply(params["pos_enc"], pts)
        x_dir = None
        if mlp_cfg.use_viewdirs and self.dir_enc is not None:
            dirs = jnp.broadcast_to(
                viewdirs[..., None, :], pts.shape[:-1] + (viewdirs.shape[-1],)
            )
            x_dir = self.dir_enc.apply(params["dir_enc"], dirs)
        return nerf_mlp_apply(mlp_params, mlp_cfg, x_pos, x_dir)

    # -- shared preamble: per-ray interval + coarse z samples ----------------

    def _coarse_z(
        self,
        rays_o: jnp.ndarray,
        rays_d: jnp.ndarray,
        k_jitter: jax.Array,
        train: bool,
        occ_grid: Optional[jnp.ndarray],
        occ_active,
        shard_info=None,
    ) -> jnp.ndarray:
        """[near, far] tightening (AABB slab + learned occupancy) and the
        stratified coarse z samples — the parameter-free front of the
        render path."""
        rcfg = self.cfg.render
        B = rays_o.shape[0]
        near = jnp.full((B, 1), rcfg.near, dtype=jnp.float32)
        far = jnp.full((B, 1), rcfg.far, dtype=jnp.float32)
        if rcfg.aabb is not None:
            # empty-space skipping: concentrate the static sample budget in
            # the ray segment intersecting the scene box (config.py aabb)
            from nerf_meets_mlx_tpu.cameras.rays import intersect_aabb

            near, far = intersect_aabb(
                rays_o, rays_d, rcfg.aabb[:3], rcfg.aabb[3:], near, far
            )
        if rcfg.occupancy and occ_grid is not None:
            from nerf_meets_mlx_tpu.acceleration.occupancy import tighten_near_far

            near, far = tighten_near_far(
                occ_grid, rays_o, rays_d, near, far, rcfg.aabb,
                rcfg.occ_threshold, rcfg.occ_n_probes, active=occ_active,
            )
        sample_fn = sample_z_lindisp if rcfg.lindisp else sample_z_uniform
        z_vals = sample_fn(near, far, rcfg.n_samples)  # [B, S]
        if train and rcfg.perturb > 0.0:
            # dtype bound explicitly: stratified_jitter's own draw uses
            # z_vals.dtype, and both branches must share one stream
            t = _shard_rand(
                functools.partial(jax.random.uniform, dtype=z_vals.dtype),
                k_jitter, z_vals.shape, shard_info,
            )
            z_vals = stratified_jitter(k_jitter, z_vals, rcfg.perturb, t=t)
        return z_vals

    # -- full hierarchical ray rendering ------------------------------------

    def render_rays(
        self,
        params: Params,
        rays_o: jnp.ndarray,     # [B, 3]
        rays_d: jnp.ndarray,     # [B, 3] (unnormalized)
        key: Optional[jax.Array] = None,
        train: bool = True,
        viewdirs: Optional[jnp.ndarray] = None,  # [B, 3] normalized
        occ_grid: Optional[jnp.ndarray] = None,  # [R, R, R] learned density
        occ_active=True,                         # bool / traced warmup gate
        shard_info=None,                         # (n_global, offset) under shard_map
    ) -> Dict[str, jnp.ndarray]:
        """Render a batch of rays; coarse + (optional) fine pass.

        ``viewdirs`` overrides the directions fed to the view-dependent head
        — required under NDC, where rays_o/rays_d are the REPROJECTED rays
        but the head must see the original world-space directions (reference:
        viewdirs computed before ndc_rays, render.py:290-307).

        ``occ_grid`` (when cfg.render.occupancy) further tightens each ray's
        [near, far] to the first/last occupied grid cell
        (acceleration/occupancy.py); ``occ_active`` gates it during warmup.

        Returns a dict with rgb/disp/acc/depth maps for both passes
        ("rgb_map" aliases the finest available, matching the reference's
        overwrite semantics at render.py:237-239) plus coarse z_vals/weights.
        """
        rcfg = self.cfg.render
        if viewdirs is None:
            viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

        if key is None:
            key = jax.random.PRNGKey(0)
        k_jitter, k_noise_c, k_imp, k_noise_f = jax.random.split(key, 4)

        z_vals = self._coarse_z(
            rays_o, rays_d, k_jitter, train, occ_grid, occ_active, shard_info
        )

        def draw_noise(k, shape):
            if not (train and rcfg.raw_noise_std > 0.0):
                return None
            return _shard_rand(jax.random.normal, k, shape, shard_info)

        pts = rays_o[..., None, :] + z_vals[..., :, None] * rays_d[..., None, :]
        raw_c = self.query(params, "coarse", pts, viewdirs)
        out_c = raw2outputs(
            raw_c,
            z_vals,
            rays_d,
            mode=rcfg.compositing,
            raw_noise_std=rcfg.raw_noise_std if train else 0.0,
            noise_key=k_noise_c,
            white_bkgd=rcfg.white_bkgd,
            density_activation=rcfg.density_activation,
            noise=draw_noise(k_noise_c, z_vals.shape),
        )

        ret = {
            "rgb_coarse": out_c["rgb_map"],
            "disp_coarse": out_c["disp_map"],
            "acc_coarse": out_c["acc_map"],
            "depth_coarse": out_c["depth_map"],
            "z_vals": z_vals,
            "weights": out_c["weights"],
            "rgb_map": out_c["rgb_map"],
            "disp_map": out_c["disp_map"],
            "acc_map": out_c["acc_map"],
            "depth_map": out_c["depth_map"],
        }

        if rcfg.n_importance > 0:
            # detached resampling stage (reference: torch.no_grad round-trip);
            # shard_info makes the internal uniform draw shard-invariant with
            # the dtype threaded inside sample_pdf itself
            z_imp = sample_pdf(
                k_imp,
                z_vals,
                out_c["weights"],
                rcfg.n_importance,
                deterministic=not train,
                shard_info=shard_info if train else None,
            )
            z_all = merge_z(z_vals, z_imp)  # [B, S + S_imp]
            pts_f = rays_o[..., None, :] + z_all[..., :, None] * rays_d[..., None, :]
            level = "fine" if "fine" in params else "coarse"
            raw_f = self.query(params, level, pts_f, viewdirs)
            out_f = raw2outputs(
                raw_f,
                z_all,
                rays_d,
                mode=rcfg.compositing,
                raw_noise_std=rcfg.raw_noise_std if train else 0.0,
                noise_key=k_noise_f,
                white_bkgd=rcfg.white_bkgd,
                density_activation=rcfg.density_activation,
                noise=draw_noise(k_noise_f, z_all.shape),
            )
            ret.update(
                rgb_fine=out_f["rgb_map"],
                disp_fine=out_f["disp_map"],
                acc_fine=out_f["acc_map"],
                depth_fine=out_f["depth_map"],
                rgb_map=out_f["rgb_map"],
                disp_map=out_f["disp_map"],
                acc_map=out_f["acc_map"],
                depth_map=out_f["depth_map"],
            )

        return ret


def create_nerf(cfg: ExperimentConfig) -> NeRFModel:
    """Build a NeRFModel from config (counterpart of create_NeRF,
    NeRF.py:51-158 — optimizer construction lives in engine/trainer.py)."""
    pos_enc = make_encoding(cfg.pos_encoding)
    dir_enc = make_encoding(cfg.dir_encoding) if cfg.dir_encoding else None
    return NeRFModel(cfg=cfg, pos_enc=pos_enc, dir_enc=dir_enc)
