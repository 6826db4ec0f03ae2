"""CTC training: optimizer and schedule, checkpoints, the trainer."""

from turkish_asr_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint_file,
    load_jax_checkpoint_file,
    save_checkpoint_file,
    save_jax_checkpoint_file,
)
from turkish_asr_torch.train.optim import make_optimizer
from turkish_asr_torch.train.trainer import Trainer

__all__ = [
    "make_optimizer",
    "save_checkpoint_file",
    "load_checkpoint_file",
    "latest_checkpoint",
    "load_jax_checkpoint_file",
    "save_jax_checkpoint_file",
    "Trainer",
]
