"""Training (the port of ``repro/train/``): the cross-entropy with z-loss,
AdamW with its schedules and clipping, and the training step."""

from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import (
    AdamWState,
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_at,
)
from repro_torch.train.step import TrainConfig, make_loss_fn, make_train_step

__all__ = [
    "AdamWState",
    "OptimizerConfig",
    "TrainConfig",
    "adamw_update",
    "clip_by_global_norm",
    "cross_entropy",
    "global_norm",
    "init_opt_state",
    "lr_at",
    "make_loss_fn",
    "make_train_step",
]
