"""CTC loss: the dispatching wrappers and the autograd Function.

Counterpart of turkish_asr_tpu/ops/ctc.py (``ctc_loss`` and ``_reduce``)
and of the custom VJP around the Pallas kernels
(turkish_asr_tpu/ops/_ctc_pallas_impl.py ``ctc_nll_pallas`` :261-339).
Log-probs on the CPU go to the plain PyTorch versions (``_ctc.py``, with
the topology of ``ctc_topology``); CUDA log-probs launch the hand-written
Hopper kernels (``csrc/ctc_fwd.cu`` for the alpha recursion and the loss,
``csrc/ctc_bwd.cu`` for the beta recursion and the gradient), which build
the extended labels, skip flags and label chains themselves from the
targets, or raise for what they do not take. Both devices go through
``CTCNegLogLikelihood``, differentiable in log_probs.

``ctc_plan`` is the kernels' launch plan, in Python so that the CPU tests
hold it. ``ctc_loss.launches_fwd`` and ``ctc_loss.launches_bwd`` count the
kernel launches.
"""

import ctypes
import threading
from collections import namedtuple

import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._ctc import NEG_INF, ctc_bwd_ref, ctc_fwd_ref, ctc_topology

FWD_SOURCES = ("ctc_fwd.cu",)
BWD_SOURCES = ("ctc_bwd.cu",)
MAX_LANES = 8192  # S = 2L + 1 the kernels take
# The launch plan's constants, as csrc/ctc_common.cuh and the kernels set them.
LANE_COUNTS = (3, 5, 7, 9, 11, 13, 15, 17, 21, 25, 29, 33)  # lanes a thread, instantiated
WIDE_WARPS, WIDE_LANES = 16, 17  # the wide path: up to 16 recursion warps of 17 lanes
PRODUCER_WARPS = {"fwd": 4, "bwd": 8}
MAX_CHUNK = 32  # frames staged a chunk
MAX_SMEM = 232448  # the H100's dynamic shared memory a block
_count_lock = threading.Lock()

Plan = namedtuple("Plan", "warps lanes chunk smem threads")


def _smem(kernel, S, warps, lanes, chunk):
    """Shared-memory bytes, as csrc/ctc_common.cuh fwd_smem_bytes and
    bwd_smem_bytes count them."""
    Sp = 32 * warps * lanes
    if kernel == "fwd":
        return 4 * (2 * chunk * Sp + 4 * warps + 2 + S)
    return 4 * (4 * chunk * Sp + 4 * warps + 2 * S) + S


def ctc_plan(kernel, S, T):
    """The launch of ``csrc/ctc_{kernel}.cu`` for S lanes and T frames:
    ``warps`` recursion warps (1 up to S = 32 * 33, the warp path; else the
    wide path), ``lanes`` contiguous lanes a thread (odd), ``chunk`` frames
    staged at a time, ``smem`` bytes of shared memory, ``threads`` a block
    (the recursion warps and the producer warps)."""
    if kernel not in PRODUCER_WARPS:
        raise ValueError(f"no CTC kernel {kernel!r}")
    if not 1 <= S <= MAX_LANES:
        raise ValueError(f"the CTC kernels take 1 to {MAX_LANES} lanes, got {S}")
    per_thread = -(-S // 32)
    if per_thread <= LANE_COUNTS[-1]:
        warps, lanes = 1, min(k for k in LANE_COUNTS if k >= per_thread)
    else:
        warps, lanes = -(-S // (32 * WIDE_LANES)), WIDE_LANES
    chunk = max(1, min(MAX_CHUNK, T))
    while chunk > 1 and _smem(kernel, S, warps, lanes, chunk) > MAX_SMEM:
        chunk -= 1
    return Plan(warps, lanes, chunk, _smem(kernel, S, warps, lanes, chunk),
                32 * (warps + PRODUCER_WARPS[kernel]))


def load_fwd_kernel():
    fn = load_library("ctc_fwd", FWD_SOURCES).ctc_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


def log1p_unit_mismatches(device="cuda"):
    """How many floats x in [0, 1], and NaNs, the kernels' branch-free
    log1p (csrc/ctc_common.cuh log1p_unit) maps to other bits than the CUDA
    math library's log1pf, counted on the card: 0 when the kernels'
    logaddexp is log1pf(expf(...)) bit for bit."""
    lib = load_library("ctc_fwd", FWD_SOURCES)
    fn = lib.log1p_unit_mismatches
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(count.device):
        rc = fn(count.data_ptr(), torch.cuda.current_stream(count.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log1p_unit_mismatches launch failed with CUDA error {rc}")
    return int(count.item())


def load_bwd_kernel():
    fn = load_library("ctc_bwd", BWD_SOURCES).ctc_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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


def _index_args(targets, input_lengths, target_lengths):
    """The three index tensors as the kernels read them (int32 or int64,
    contiguous: no copy when they already are) and the flags that say
    which are int64 (csrc/ctc_common.cuh)."""
    out, flags = [], 0
    for bit, x in enumerate((targets, input_lengths, target_lengths)):
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int32)
        flags |= (x.dtype == torch.int64) << bit
        out.append(x.contiguous())
    return out, flags


def _forward(log_probs, targets, input_lengths, target_lengths, blank_id):
    """(nll (B,), alpha (B, T, S)): the forward kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if log_probs.device.type == "cpu":
        ext, allow_skip = ctc_topology(targets, blank_id)
        return ctc_fwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths)
    B, T, V = log_probs.shape
    L = targets.shape[1]
    plan = ctc_plan("fwd", 2 * L + 1, T)
    lp = log_probs.contiguous()
    (tg, il, tl), flags = _index_args(targets, input_lengths, target_lengths)
    alpha = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=lp.device)
    nll = torch.empty((B,), dtype=torch.float32, device=lp.device)
    fn = load_fwd_kernel()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), tg.data_ptr(), il.data_ptr(), tl.data_ptr(), alpha.data_ptr(),
                nll.data_ptr(), B, T, V, L, int(blank_id), flags, plan.warps, plan.lanes,
                plan.chunk, plan.smem, torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_fwd launch failed with CUDA error {rc}")
    _count("launches_fwd")
    return nll, alpha


def _backward(log_probs, targets, input_lengths, target_lengths, alpha, nll, cot, blank_id):
    """(B, T, V) gradient: the backward kernel on CUDA tensors, its plain
    version on CPU tensors. The kernel writes every element, zeros
    included, so the gradient is allocated with torch.empty."""
    if log_probs.device.type == "cpu":
        ext, allow_skip = ctc_topology(targets, blank_id)
        return ctc_bwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths, alpha,
                           nll, cot)
    B, T, V = log_probs.shape
    L = targets.shape[1]
    plan = ctc_plan("bwd", 2 * L + 1, T)
    lp = log_probs.contiguous()
    (tg, il, tl), flags = _index_args(targets, input_lengths, target_lengths)
    cot = cot.float().contiguous()
    grad = torch.empty((B, T, V), dtype=torch.float32, device=lp.device)
    fn = load_bwd_kernel()
    with torch.cuda.device(lp.device):
        rc = fn(lp.data_ptr(), tg.data_ptr(), il.data_ptr(), tl.data_ptr(),
                alpha.contiguous().data_ptr(), nll.contiguous().data_ptr(), cot.data_ptr(),
                grad.data_ptr(), B, T, V, L, int(blank_id), flags, plan.warps, plan.lanes,
                plan.chunk, plan.smem, torch.cuda.current_stream(lp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_bwd launch failed with CUDA error {rc}")
    _count("launches_bwd")
    return grad


class CTCNegLogLikelihood(torch.autograd.Function):
    """Per-sample CTC negative log-likelihood (B,), before zero_infinity."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank_id):
        nll, alpha = _forward(log_probs, targets, input_lengths, target_lengths, blank_id)
        ctx.save_for_backward(log_probs, targets, input_lengths, target_lengths, alpha, nll)
        ctx.blank_id = blank_id
        return nll

    @staticmethod
    def backward(ctx, g):
        log_probs, targets, il, tl, alpha, nll = ctx.saved_tensors
        grad = _backward(log_probs, targets, il, tl, alpha, nll, g, ctx.blank_id)
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
