"""Kernel wrappers, their plain PyTorch versions, and the nvcc build of csrc/."""
