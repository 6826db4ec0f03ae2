"""Checkpoints: the reference's ``.pt`` and the JAX package's ``.ckpt``.

The port's trainer writes what the reference's trainer wrote (the
reference trainer, trainer/trainer.py:84-145): one ``torch.save`` dict with
``model_state_dict`` (the reference's keys, which ``utils/weights.load_pt``
and the server read), ``config`` (the run's flags), ``model_config``,
``epoch``, ``global_step``, ``best_val_loss``, ``optimizer_state_dict`` and
``scheduler_state_dict``. Files are ``checkpoint_epoch_{E}.pt`` and
``best_model.pt``, written by atomic rename.

It also reads and writes the JAX package's ``.ckpt``
(turkish_asr_tpu/train/checkpoint.py:41-57): flax ``msgpack_serialize``
of ``{"meta", "params", "model_state", "opt_named"}``, through the port's
own msgpack code (``utils/msgpack_read.py``), so a model trained with
``python main.py`` is served, resumed and converted without jax, flax or
msgpack. ``utils/weights.py`` maps the trees to the port's state dict and
optimizer. Resume takes the newest ``checkpoint_epoch_*.pt`` or
``checkpoint_epoch_*.ckpt`` by mtime.
"""

import glob
import os

import torch

from turkish_asr_torch.utils import msgpack_read


def save_checkpoint_file(path, payload):
    """``torch.save`` to a temporary file, then rename over ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_file(path):
    """The checkpoint dict, tensors on the CPU (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_jax_checkpoint_file(path):
    """A JAX ``.ckpt`` as ``{"meta", "params", "model_state", "opt_named"}``
    of numpy trees (bf16 leaves as ``torch.bfloat16`` tensors); the parts
    the file lacks are empty dicts, ``opt_named`` None."""
    with open(path, "rb") as f:
        payload = msgpack_read.unpackb(f.read())
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: not a JAX checkpoint (top level is "
                         f"{type(payload).__name__}, not a map)")
    return {"meta": payload.get("meta") or {}, "params": payload.get("params") or {},
            "model_state": payload.get("model_state") or {},
            "opt_named": payload.get("opt_named")}


def save_jax_checkpoint_file(path, meta, params, model_state, opt_named=None):
    """The JAX ``save_checkpoint_file``'s file, written by the port: the
    same payload (trees of numpy arrays or tensors) and the same atomic
    rename; ``opt_named`` is the optax state by key path
    (``utils/weights.opt_named_from_optimizer``)."""
    payload = {"meta": dict(meta), "params": params, "model_state": model_state}
    if opt_named is not None:
        payload["opt_named"] = opt_named
    blob = msgpack_read.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def latest_checkpoint(checkpoint_dir, patterns=("checkpoint_epoch_*.pt",
                                                "checkpoint_epoch_*.ckpt")):
    """Newest epoch checkpoint of either format by mtime (the reference's
    and the JAX package's resume rule)."""
    candidates = sorted((p for pattern in patterns
                         for p in glob.glob(os.path.join(checkpoint_dir, pattern))),
                        key=os.path.getmtime)
    return candidates[-1] if candidates else None
