"""Checkpoints (the port of ``repro/ckpt/``)."""

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
