"""Train state + optimizer construction.

The reference shares ONE mlx Adam instance across coarse and fine models
(/root/reference/mlx_nerf/models/NeRF.py:120, __test_nerf.py:128,138) with
moment state keyed per parameter tree. Here a single optax Adam runs over the
WHOLE params pytree (coarse + fine + encodings) — per-leaf moments, so the
semantics match while the state is explicit, checkpointable, and shardable.

The learning-rate schedule reproduces __test_nerf.py:302-305 exactly:
lr(step) = lrate * 0.1 ** (step / (lrate_decay * 1000)), continuous decay.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from nerf_meets_mlx_tpu.config import TrainConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray          # int32 scalar
    params: Any
    opt_state: Any
    # learned occupancy grid [R, R, R] (acceleration/occupancy.py) — auxiliary
    # non-optimized state, EMA-updated inside the train step; None when
    # render.occupancy is off
    occ_grid: Any = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def lr_schedule(cfg: TrainConfig):
    if cfg.lrate_decay <= 0:
        return cfg.lrate
    return optax.exponential_decay(
        init_value=cfg.lrate,
        transition_steps=cfg.lrate_decay * 1000,
        decay_rate=0.1,
        staircase=False,
    )


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    tx = optax.adam(lr_schedule(cfg), b1=cfg.adam_b1, b2=cfg.adam_b2)
    if cfg.encoding_weight_decay > 0.0:
        # decoupled L2 on the learned-encoding parameters only (hash tables /
        # CP factor lines). High-capacity hash tables memorize sparse view
        # sets otherwise (measured: lego_ingp train 28.7 dB / test 15.3 dB
        # on the hard scene without it); MLP weights stay decay-free like
        # the reference's plain Adam.
        def enc_mask(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: any(
                    getattr(k, "key", None) == "pos_enc" for k in path
                ),
                params,
            )

        tx = optax.chain(
            tx, optax.add_decayed_weights(-cfg.encoding_weight_decay, mask=enc_mask)
        )
    return tx


def create_train_state(
    params: Any, cfg: TrainConfig, occ_grid: Any = None
) -> TrainState:
    tx = make_optimizer(cfg)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        occ_grid=occ_grid,
    )
