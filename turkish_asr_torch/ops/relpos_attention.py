"""Relative-position attention (Transformer-XL, as Conformer uses it): the
dispatching wrapper.

The forward is the PyTorch op ``turkish_asr_torch::flash_attention_relpos_fwd``
(``torch.library.custom_op``, registered when this module is imported): its
CPU implementation is the plain version (``_relpos_attention.py``), its CUDA
implementation the hand-written Hopper kernel
(``csrc/flash_attention_relpos_fwd.cu``), which takes bf16 q, k, v and p
with a head size of 64 or 128 (one template instance each) and raises for
anything else. Forward only: with
gradients the CPU takes the plain version through autograd, and a CUDA
tensor is refused, since no backward kernel exists.

``relpos_attention`` is the span ``attn_relpos_fwd`` of ``utils/tracing.py``
(B, H, T, D, dtype); the counter ``flash_attention_relpos_fwd`` counts the
kernel's launches.
"""

import ctypes

import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._relpos_attention import relpos_attention_ref
from turkish_asr_torch.utils import tracing

KERNEL_SOURCES = ("flash_attention_relpos_fwd.cu",)
BLOCK_ROWS = 128  # query rows a block: two consumer warpgroups of 64 (the kernel's)
HEAD_DIMS = (64, 128)
tracing.count("flash_attention_relpos_fwd", 0)
_entry = []


def load_kernel():
    """The kernel's C entry point, building the library at first use."""
    if not _entry:
        fn = load_library("flash_attention_relpos_fwd", KERNEL_SOURCES).flash_attention_relpos_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _entry.append(fn)
    return _entry[0]


def _check(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if p.shape != (2 * T - 1, H, D):
        raise ValueError(f"p must be (2T-1, H, D) = {(2 * T - 1, H, D)}, got {tuple(p.shape)}")
    if pos_bias_u.shape != (H, D) or pos_bias_v.shape != (H, D):
        raise ValueError(f"pos_bias_u and pos_bias_v must be (H, D) = {(H, D)}, got "
                         f"{tuple(pos_bias_u.shape)}, {tuple(pos_bias_v.shape)}")
    if lengths.shape != (B,) or lengths.is_floating_point():
        raise ValueError(f"lengths must be (B,) integers, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    for t in (k, v, p, pos_bias_u, pos_bias_v, lengths):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")


def _check_kernel(q, k, v, p):
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes a head size of 64 or 128, got {q.shape[-1]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, p)):
        raise ValueError(f"the kernel takes bf16 q, k, v and p, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}/{p.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v, p)):
        raise ValueError("the kernel takes contiguous, 16-byte aligned q, k, v and p")


@torch.library.custom_op("turkish_asr_torch::flash_attention_relpos_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_relpos_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               p: torch.Tensor, pos_bias_u: torch.Tensor,
                               pos_bias_v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``torch.ops.turkish_asr_torch.flash_attention_relpos_fwd``: the (B, T,
    H, D) context in q's dtype (``_relpos_attention.py`` states the
    function). On CPU tensors the plain version; on CUDA tensors the
    kernel."""
    return relpos_attention_ref(q, k, v, p, pos_bias_u, pos_bias_v, lengths)


@flash_attention_relpos_fwd.register_kernel("cuda")
def _fwd_cuda(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    _check_kernel(q, k, v, p)
    B, T, H, D = q.shape
    u = pos_bias_u.float().contiguous()
    w = pos_bias_v.float().contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = load_kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), u.data_ptr(),
                w.data_ptr(), lens.data_ptr(), out.data_ptr(), B, T, H, D,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_relpos_fwd launch failed with CUDA error {rc}")
    tracing.count("flash_attention_relpos_fwd")
    return out


@flash_attention_relpos_fwd.register_fake
def _fwd_fake(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    return torch.empty_like(q)


def relpos_attention(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    """(B, T, H, D) context of relative-position attention in q's dtype.

    q, k, v (B, T, H, D); p (2T-1, H, D), the projected relative positions
    from T-1 down to -(T-1); pos_bias_u, pos_bias_v (H, D); lengths (B,)
    integers, key j of row b valid where j < lengths[b]. The kernel on CUDA
    tensors, the plain version on CPU tensors (differentiable there)."""
    _check(q, k, v, p, pos_bias_u, pos_bias_v, lengths)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"relpos_attention runs on cpu or cuda tensors, got {q.device}")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, p, pos_bias_u, pos_bias_v))
    if grad and q.device.type == "cuda":
        raise NotImplementedError(
            "relative-position attention has no backward kernel: training the Conformer "
            "block on the card is not implemented (run it under torch.no_grad())")
    B, T, H, D = q.shape
    with tracing.span("attn_relpos_fwd", B=B, H=H, T=T, D=D,
                      dtype="bf16" if q.dtype == torch.bfloat16 else "fp32"):
        if grad:
            return relpos_attention_ref(q, k, v, p, pos_bias_u, pos_bias_v, lengths)
        return flash_attention_relpos_fwd(q, k, v, p, pos_bias_u, pos_bias_v, lengths)


def relpos_attention_plain(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    """``relpos_attention``'s function through its plain version on any
    device, differentiated by autograd (the kernel-off core of the model,
    ``attn_kernel=False``): it launches no kernel and counts nothing; the
    scores are materialised, (B, H, T, 2T-1) and (B, H, T, T) fp32."""
    _check(q, k, v, p, pos_bias_u, pos_bias_v, lengths)
    return relpos_attention_ref(q, k, v, p, pos_bias_u, pos_bias_v, lengths)
