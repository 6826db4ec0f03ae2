"""The device a caller names, checked; never guessed."""

import torch


def resolve_device(device):
    """torch.device for ``device``; raises if it names CUDA and PyTorch
    sees no CUDA device. There is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev
