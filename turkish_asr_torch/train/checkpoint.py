"""Checkpoints in the reference's ``.pt`` contract.

Counterpart of turkish_asr_tpu/train/checkpoint.py, which writes msgpack
``.ckpt`` files; the port writes what the reference's trainer wrote
(the reference trainer, trainer/trainer.py:84-145): one ``torch.save`` dict with
``model_state_dict`` (the reference's keys, which ``utils/weights.load_pt``
and the server read), ``config`` (the run's flags), ``model_config``,
``epoch``, ``global_step``, ``best_val_loss``, ``optimizer_state_dict`` and
``scheduler_state_dict``. Files are ``checkpoint_epoch_{E}.pt`` and
``best_model.pt``, written by atomic rename; resume takes the newest
``checkpoint_epoch_*.pt`` by mtime. Reading the JAX package's ``.ckpt``
is not ported (ROADMAP D1).
"""

import glob
import os

import torch


def save_checkpoint_file(path, payload):
    """``torch.save`` to a temporary file, then rename over ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_file(path):
    """The checkpoint dict, tensors on the CPU (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(checkpoint_dir, pattern="checkpoint_epoch_*.pt"):
    """Newest epoch checkpoint by mtime (the reference's resume rule)."""
    candidates = sorted(glob.glob(os.path.join(checkpoint_dir, pattern)), key=os.path.getmtime)
    return candidates[-1] if candidates else None
