"""Kernel wrappers, their plain PyTorch versions, and the nvcc build of csrc/."""

from turkish_asr_torch.ops.ctc import ctc_loss, ctc_loss_numpy_oracle

__all__ = [
    "ctc_loss",
    "ctc_loss_numpy_oracle",
]
