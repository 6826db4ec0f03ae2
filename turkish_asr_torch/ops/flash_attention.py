"""Flash-attention forward: the dispatching wrapper.

Counterpart of turkish_asr_tpu/ops/flash_attention.py. A tensor on the CPU
goes to the plain PyTorch version (``_flash_attention.py``); a CUDA tensor
launches the hand-written Hopper kernel (``csrc/flash_attention_fwd.cu``)
at every sequence length, or raises for what the kernel does not take.
``flash_attention.launches`` counts kernel launches.
"""

import ctypes
import threading

import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref

KERNEL_SOURCES = ("flash_attention_fwd.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def load_kernel():
    """The kernel's C entry point, building the library at first use."""
    lib = load_library("flash_attention_fwd", KERNEL_SOURCES)
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _check(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, D) and (B, Kh, T, D)")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (T, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if k.shape[1] not in (1, H):
        raise ValueError(f"k/v heads must be 1 or {H}, got {k.shape[1]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes bf16 or fp32 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D % 8 != 0 or D > 128:
        raise ValueError(f"kernel takes a head dim that is a multiple of 8 up to 128, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if mask is not None:
        if mask.shape != (B, T) or mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"mask must be (B, T) bool or uint8, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        if not mask.is_contiguous():
            raise ValueError("kernel takes a contiguous mask")
    for t in (k, v) + (() if mask is None else (mask,)):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")


def flash_attention(q, k, v, mask=None):
    """(out (B, H, T, D) fp32, lse (B, H, T) fp32) of masked attention.

    q (B, H, T, D); k, v (B, Kh, T, D) with Kh in (1, H); mask (B, T) bool
    or uint8, or None for all keys valid.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.uint8, device=q.device)
    mask = mask.view(torch.uint8)
    out = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = load_kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, H, k.shape[1], T, D,
                _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {rc}")
    with _count_lock:
        flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
