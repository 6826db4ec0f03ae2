"""CTC loss: the dispatching wrappers and the autograd Function.

Counterpart of turkish_asr_tpu/ops/ctc.py (``ctc_loss`` and ``_reduce``)
and of the custom VJP around the Pallas kernels
(turkish_asr_tpu/ops/_ctc_pallas_impl.py ``ctc_nll_pallas`` :261-339).
Log-probs on the CPU go to the plain PyTorch versions (``_ctc.py``); CUDA
log-probs launch the hand-written Hopper kernels (``csrc/ctc_fwd.cu`` for
the alpha recursion and the loss, ``csrc/ctc_bwd.cu`` for the beta
recursion and the gradient), or raise for what they do not take. Both
devices go through ``CTCNegLogLikelihood``, differentiable in log_probs.

``ctc_loss.launches_fwd`` and ``ctc_loss.launches_bwd`` count the kernel
launches.
"""

import ctypes
import threading

import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._ctc import (
    NEG_INF, ctc_bwd_ref, ctc_fwd_ref, ctc_topology, label_chains)

FWD_SOURCES = ("ctc_fwd.cu",)
BWD_SOURCES = ("ctc_bwd.cu",)
MAX_LANES = 8192  # S = 2L + 1 the kernels take (8 lanes a thread, 1024 threads)
_count_lock = threading.Lock()


def load_fwd_kernel():
    fn = load_library("ctc_fwd", FWD_SOURCES).ctc_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def load_bwd_kernel():
    fn = load_library("ctc_bwd", BWD_SOURCES).ctc_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def _count(attr):
    with _count_lock:
        setattr(ctc_loss, attr, getattr(ctc_loss, attr) + 1)


def _check(log_probs, targets, input_lengths, target_lengths):
    if log_probs.dim() != 3 or targets.dim() != 2:
        raise ValueError("log_probs must be (B, T, V) and targets (B, L)")
    B = log_probs.shape[0]
    if targets.shape[0] != B or input_lengths.shape != (B,) or target_lengths.shape != (B,):
        raise ValueError(f"targets {tuple(targets.shape)}, input_lengths "
                         f"{tuple(input_lengths.shape)} and target_lengths "
                         f"{tuple(target_lengths.shape)} do not match batch {B}")
    if log_probs.dtype != torch.float32:
        raise ValueError(f"ctc_loss takes fp32 log_probs, got {log_probs.dtype}")
    if 2 * targets.shape[1] + 1 > MAX_LANES:
        raise ValueError(f"the CTC kernels take targets up to {(MAX_LANES - 1) // 2} labels, "
                         f"got {targets.shape[1]}")
    for t in (targets, input_lengths, target_lengths):
        if t.device != log_probs.device:
            raise ValueError(f"all inputs must be on {log_probs.device}, got {t.device}")


def _cuda_ints(x):
    return x.to(torch.int32).contiguous()


def _forward(log_probs, ext, allow_skip, input_lengths, target_lengths):
    """(nll (B,), alpha (B, T, S)): the forward kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if log_probs.device.type == "cpu":
        return ctc_fwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths)
    B, T, V = log_probs.shape
    S = ext.shape[1]
    lp = log_probs.contiguous()
    ext, skip = ext.contiguous(), allow_skip.to(torch.uint8).contiguous()
    il, tl = _cuda_ints(input_lengths), _cuda_ints(target_lengths)
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=lp.device)
    nll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    fn = load_fwd_kernel()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), ext.data_ptr(), skip.data_ptr(), il.data_ptr(), tl.data_ptr(),
                alpha.data_ptr(), nll.data_ptr(), B, T, V, S,
                torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_fwd launch failed with CUDA error {rc}")
    _count("launches_fwd")
    return nll, alpha


def _backward(log_probs, ext, allow_skip, input_lengths, target_lengths, alpha, nll, cot,
              blank_id):
    """(B, T, V) gradient: the backward kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if log_probs.device.type == "cpu":
        return ctc_bwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths, alpha,
                           nll, cot)
    B, T, V = log_probs.shape
    S = ext.shape[1]
    lp = log_probs.contiguous()
    next_same, leader = label_chains(ext)
    skip, leader = allow_skip.to(torch.uint8).contiguous(), leader.to(torch.uint8).contiguous()
    il, tl = _cuda_ints(input_lengths), _cuda_ints(target_lengths)
    cot = cot.float().contiguous()
    grad = torch.zeros((B, T, V), dtype=torch.float32, device=lp.device)
    fn = load_bwd_kernel()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), ext.contiguous().data_ptr(), skip.data_ptr(),
                next_same.contiguous().data_ptr(), leader.data_ptr(), il.data_ptr(),
                tl.data_ptr(), alpha.data_ptr(), nll.data_ptr(), cot.data_ptr(),
                grad.data_ptr(), B, T, V, S, int(blank_id),
                torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_bwd launch failed with CUDA error {rc}")
    _count("launches_bwd")
    return grad


class CTCNegLogLikelihood(torch.autograd.Function):
    """Per-sample CTC negative log-likelihood (B,), before zero_infinity."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank_id):
        ext, allow_skip = ctc_topology(targets, blank_id)
        nll, alpha = _forward(log_probs, ext, allow_skip, input_lengths, target_lengths)
        ctx.save_for_backward(log_probs, ext, allow_skip, input_lengths, target_lengths,
                              alpha, nll)
        ctx.blank_id = blank_id
        return nll

    @staticmethod
    def backward(ctx, g):
        log_probs, ext, allow_skip, il, tl, alpha, nll = ctx.saved_tensors
        grad = _backward(log_probs, ext, allow_skip, il, tl, alpha, nll, g, ctx.blank_id)
        return grad, None, None, None, None


def _reduce(loss, target_lengths, reduction, zero_infinity):
    """turkish_asr_tpu/ops/ctc.py:140, kept exactly: infinite losses (the
    sentinel's 1e30 scale) become 0, NaN passes through; 'mean' divides by
    max(target_length, 1), then averages over the batch."""
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF * 0.5, 0.0, loss)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return (loss / target_lengths.clamp(min=1)).mean()


def ctc_loss(log_probs, targets, input_lengths, target_lengths, blank_id=0, reduction="mean",
             zero_infinity=True):
    """CTC negative log-likelihood.

    Args:
        log_probs: (B, T, V) fp32 log-softmax outputs, batch-first.
        targets: (B, L) padded target ids.
        input_lengths, target_lengths: (B,) valid frame and label counts.
        reduction: "mean" (per-sample loss / target length, then batch
            mean), "sum", or "none".

    Returns:
        a scalar, or (B,) for reduction="none".
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got {reduction!r}")
    _check(log_probs, targets, input_lengths, target_lengths)
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ctc_loss runs on cpu or cuda tensors, got {log_probs.device}")
    nll = CTCNegLogLikelihood.apply(log_probs, targets, input_lengths, target_lengths,
                                    int(blank_id))
    return _reduce(nll, target_lengths.to(log_probs.device), reduction, zero_infinity)


ctc_loss.launches_fwd = 0
ctc_loss.launches_bwd = 0
