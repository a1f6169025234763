"""Checkpoints in the reference's ``.npz`` format (``checkpoint`` module)."""
from repro_torch.ckpt.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "restore_train_state",
    "save_checkpoint",
    "save_train_state",
]
