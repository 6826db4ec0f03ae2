"""Flash attention: the dispatching wrappers and the autograd Function.

Counterpart of turkish_asr_tpu/ops/flash_attention.py and of the custom
VJP in turkish_asr_tpu/ops/_flash_attention_impl.py (:124-143). A tensor on
the CPU goes to the plain PyTorch versions (``_flash_attention.py``); a
CUDA tensor launches the hand-written Hopper kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) at every
sequence length, or raises for what they do not take.

The forward is the PyTorch op ``turkish_asr_torch::flash_attention_fwd``
(``torch.library.custom_op``, registered when this module is imported):
its CPU implementation is the plain version, its CUDA implementation
the kernel, and its fake implementation gives ``torch.export`` the output
shapes, so an exported program holds one op node a block and launches the
kernel when it runs (load a saved ``.pt2`` after importing this module).
Without gradients (serving, export) ``flash_attention`` calls the op
directly; with them, ``torch.autograd.Function`` ``FlashAttention``,
whose forward calls the op and saves q, k, v, mask, out, the softmax's
row max and sum, and the dropout seed; its backward takes delta =
rowsum(g * out) in PyTorch, as the TPU package takes it outside its
kernel, and runs the backward kernels. ``attention_plan`` is the
kernels' launch arithmetic (tile rows, ring stages, the dk/dv kernel's
chunks of query rows and every grid); the wrapper allocates their
scratch: the chunks' fp32 partial dk/dv and the bf16 ds that the dq
kernel reads.

Attention-weight dropout (training) is applied inside the kernels from a
position hash (``_dropout.py``, ``csrc/dropout_hash.cuh``) keyed by
``seed``, so the backward, and the dump kernel behind ``dump_keep_mask``,
regenerate the same mask.

The counters ``flash_attention_fwd`` and ``flash_attention_bwd`` of
``utils/tracing.py`` count the forward and backward kernel launches,
``dropout_mask`` the dump kernel's; ``_fwd`` is the span ``attn_fwd``.
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._dropout import keep_mask_ref, keep_threshold
from turkish_asr_torch.ops._flash_attention import (
    flash_attention_bwd_ref, flash_attention_fwd_stats_ref)
from turkish_asr_torch.parallel.mesh import shard_seed
from turkish_asr_torch.utils import tracing

KERNEL_SOURCES = ("flash_attention_fwd.cu",)
BWD_SOURCES = ("flash_attention_bwd.cu",)
DUMP_SOURCES = ("dropout_mask.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_entry_points = {}
tracing.count("flash_attention_fwd", 0)
tracing.count("flash_attention_bwd", 0)
tracing.count("dropout_mask", 0)


def _entry_point(library, sources, symbol, argtypes):
    """The C function ``symbol`` with its argtypes set, built and loaded at
    first use and kept: a launch pays for no lookup or argtypes setup."""
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(load_library(library, sources), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entry_points[symbol] = fn
    return fn


def load_kernel():
    """The forward kernel's C entry point, building the library at first use."""
    return _entry_point("flash_attention_fwd", KERNEL_SOURCES, "flash_attention_fwd",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])


def load_bwd_kernel():
    """The backward kernels' C entry point, building the library at first use."""
    return _entry_point("flash_attention_bwd", BWD_SOURCES, "flash_attention_bwd",
                        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13
                        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])


def load_dump_kernel():
    return _entry_point("dropout_mask", DUMP_SOURCES, "dump_keep_mask",
                        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2
                        + [ctypes.c_void_p])


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


def _check_dropout(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    return q.device.type


def _mask_u8(mask, B, T, device):
    if mask is None:
        return torch.ones((B, T), dtype=torch.uint8, device=device)
    return mask.view(torch.uint8)


def _dropout_args(rate, seed):
    return (int(rate > 0.0), int(seed), keep_threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate))


TILE = 64  # rows of a query or key tile: one consumer warpgroup's (csrc/flash_wgmma.cuh)
GROUPS = 2  # consumer warpgroups of a bf16 block (fp32: one)


class AttentionPlan(NamedTuple):
    """The launches of the attention kernels (``attention_plan``)."""
    block_rows: int   # query rows of a forward or dq block; keys of a dk/dv block
    fwd_stages: int   # K/V tiles in the forward's ring
    fwd_grid: tuple   # (row blocks, 1, B * Kh)
    bwd_stages: int   # Q/G tiles in the dk/dv kernel's ring
    chunks: int       # runs of query rows the dk/dv grid splits a kv head's rows into
    chunk_rows: int   # rows of each run but the last: a multiple of TILE
    dkdv_grid: tuple  # (key blocks, chunks, B * Kh)
    dq_grid: tuple    # (row blocks, 1, B * Kh)
    pitch: int        # elements between rows of the backward's ds scratch


@functools.lru_cache(maxsize=None)
def attention_plan(B, H, Kh, T, D, fp32, slots):
    """How ``csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``
    launch for q (B, H, T, D) and k, v (B, Kh, T, D), bf16 or ``fp32``, on a
    card that holds ``slots`` dk/dv blocks at once (SMs x blocks an SM,
    ``_dkdv_slots``; the forward's numbers do not depend on it, and the
    forward passes 1). The kernels take every number from here and refuse
    a plan that is not their instance's or a grid that does not cover its
    rows.

    A block holds GROUPS consumer warpgroups of TILE rows (one for fp32,
    whose bf16 parts fill shared memory), so block_rows query rows
    (forward, dq) or keys (dk/dv). The rows of a kv head are H*T folded
    rows for MQA and T for MHA. The forward's ring has two stages; the
    dk/dv kernel's two for bf16 at D <= 64 and one otherwise (shared
    memory). The dk/dv grid is key blocks x chunks x B*Kh: a block stages
    its K/V, walks its chunk's row tiles and writes its dk/dv, so the grid
    takes about waves x (row tiles a chunk + 1) tile-steps; the split with
    the fewest of those wins, the fewer chunks on a tie (each adds a
    partial dk/dv to sum). No chunk is empty. The backward's ds scratch
    keeps each key's rows ``pitch`` elements apart: the rows rounded up to
    8 (16 bytes, as TMA needs). Cached: a launch pays for one dictionary
    lookup."""
    block = TILE * (1 if fp32 else GROUPS)
    rows = H * T if Kh == 1 else T
    row_tiles = -(-rows // TILE)
    key_blocks = -(-T // block)
    best = None
    for want in range(1, row_tiles + 1):
        per = -(-row_tiles // want)
        chunks = -(-row_tiles // per)
        cost = -(-key_blocks * B * Kh * chunks // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, chunks, per * TILE)
    _, chunks, chunk_rows = best
    row_blocks = -(-rows // block)
    return AttentionPlan(block, 2, (row_blocks, 1, B * Kh), 2 if not fp32 and D <= 64 else 1,
                         chunks, chunk_rows, (key_blocks, chunks, B * Kh),
                         (row_blocks, 1, B * Kh), -(-rows // 8) * 8)


@functools.lru_cache(maxsize=None)
def _dkdv_slots(index, D, dtype_code, dropout):
    """dk/dv blocks card ``index`` holds at once for the kernel instance
    that (D, dtype, dropout) launches: its SMs times the blocks an SM takes,
    which the CUDA runtime works out from the instance's registers and
    shared memory."""
    fn = _entry_point("flash_attention_bwd", BWD_SOURCES, "flash_attention_bwd_dkdv_occupancy",
                      [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(D, dtype_code, dropout, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"flash_attention_bwd_dkdv_occupancy failed with CUDA error {rc} "
                           f"({blocks.value} blocks an SM)")
    return blocks.value * torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned (the kernels
    copy 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@torch.library.custom_op("turkish_asr_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], rate: float,
                        seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward as a PyTorch op, ``torch.ops.turkish_asr_torch.flash_attention_fwd``:
    (out (B, H, T, D), lse, row max, row sum (B, H, T)), all fp32. On CPU
    tensors the plain version; on CUDA tensors the kernel
    (``_fwd_cuda``); any other device has no implementation and raises.
    As an op it is traced whole by ``torch.export`` (``register_fake``),
    so an exported program launches the kernel."""
    return flash_attention_fwd_stats_ref(q, k, v, mask, rate, seed)


@flash_attention_fwd.register_kernel("cuda")
def _fwd_cuda(q, k, v, mask, rate, seed):
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    mask = _mask_u8(mask, B, T, q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    lse, row_max, row_sum = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
                             for _ in range(3))
    plan = attention_plan(B, H, k.shape[1], T, D, q.dtype == torch.float32, 1)
    fn = load_kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
                B, H, k.shape[1], T, D, _DTYPE_CODE[q.dtype], *_dropout_args(rate, seed),
                plan.block_rows, plan.fwd_stages, plan.fwd_grid[0],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {rc}")
    tracing.count("flash_attention_fwd")
    return out, lse, row_max, row_sum


@flash_attention_fwd.register_fake
def _fwd_fake(q, k, v, mask, rate, seed):
    B, H, T, D = q.shape
    return (q.new_empty((B, H, T, D), dtype=torch.float32),
            *(q.new_empty((B, H, T), dtype=torch.float32) for _ in range(3)))


def _fwd(q, k, v, mask, rate, seed):
    """(out, lse, row_max, row_sum) from the op: the kernel (CUDA) or its
    plain version (CPU)."""
    _device_of(q)
    B, H, T, D = q.shape
    with tracing.span("attn_fwd", B=B, H=H, Kh=k.shape[1], T=T, D=D,
                      dtype="bf16" if q.dtype == torch.bfloat16 else "fp32"):
        return flash_attention_fwd(q, k, v, mask, rate, seed)


def _bwd(q, k, v, mask, row_max, row_sum, delta, g, rate, seed):
    """(dq, dk, dv) fp32 from the backward kernels (CUDA) or the plain
    version (CPU)."""
    if _device_of(q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, mask, row_max, row_sum, delta, g, rate, seed)
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    Kh = k.shape[1]
    mask = _mask_u8(mask, B, T, q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    g = _aligned(g.float().contiguous())
    dq = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty((2, B, Kh, T, D), dtype=torch.float32, device=q.device).unbind(0)
    dropout, seed, threshold, inv_keep = _dropout_args(rate, seed)
    plan = attention_plan(B, H, Kh, T, D, q.dtype == torch.float32,
                          _dkdv_slots(q.device.index, D, _DTYPE_CODE[q.dtype], dropout))
    partial = (torch.empty((2, plan.chunks, B, Kh, T, D), dtype=torch.float32, device=q.device)
               if plan.chunks > 1 else None)
    ds = torch.empty((2 * B * Kh * T * plan.pitch,), dtype=torch.bfloat16, device=q.device)
    fn = load_bwd_kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
                row_max.data_ptr(), row_sum.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), None if partial is None else partial.data_ptr(),
                ds.data_ptr(), B, H, Kh, T, D, _DTYPE_CODE[q.dtype], dropout, plan.chunks,
                plan.chunk_rows, plan.block_rows, plan.bwd_stages, plan.dq_grid[0], plan.pitch,
                seed, threshold, inv_keep, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with CUDA error {rc}")
    tracing.count("flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out, lse of masked attention; differentiable in q, k, v (lse is not)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, rate, seed):
        out, lse, row_max, row_sum = _fwd(q, k, v, mask, rate, seed)
        ctx.save_for_backward(q, k, v, mask, out, row_max, row_sum)
        ctx.rate, ctx.seed = rate, seed
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, mask, out, row_max, row_sum = ctx.saved_tensors
        delta = (g.float() * out).sum(dim=-1)
        dq, dk, dv = _bwd(q, k, v, mask, row_max, row_sum, delta, g, ctx.rate, ctx.seed)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q, k, v, mask=None, dropout_rate=0.0, seed=0, data_rank=0):
    """(out (B, H, T, D) fp32, lse (B, H, T) fp32) of masked attention.

    q (B, H, T, D); k, v (B, Kh, T, D) with Kh in (1, H); mask (B, T) bool
    or uint8, or None for all keys valid. ``dropout_rate`` in [0, 1) drops
    attention weights with the position hash keyed by ``seed`` (an int in
    [0, 2^32)). Differentiable in q, k and v.

    ``data_rank``: the caller's rank on a mesh's "data" axis. With dropout
    the kernel's seed is (seed + data_rank * 0x6A09E667) mod 2^32, so the
    data ranks draw different masks (JAX ``_SHARD_SEED_MIX``,
    turkish_asr_tpu/ops/flash_attention.py:96-98).
    """
    rate = float(dropout_rate)
    _check_dropout(rate, seed)
    if rate > 0.0:
        seed = shard_seed(seed, data_rank, bits=32)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, mask, rate, int(seed))
    out, lse, _, _ = _fwd(q, k, v, mask, rate, int(seed))  # inference, and torch.export
    return out, lse


def flash_attention_plain(q, k, v, mask=None, dropout_rate=0.0, seed=0, data_rank=0):
    """``flash_attention``'s function through its plain version
    (``_flash_attention.flash_attention_fwd_stats_ref``) on any device,
    differentiated by autograd: the kernel-off core of the model
    (``attn_kernel=False``), the counterpart of the JAX package's einsum
    core (``attn_kernel=None``). It launches no kernel and counts nothing;
    the scores are materialized, (B, H*T, T) fp32 for MQA."""
    rate = float(dropout_rate)
    _check_dropout(rate, seed)
    if rate > 0.0:
        seed = shard_seed(seed, data_rank, bits=32)
    out, lse, _, _ = flash_attention_fwd_stats_ref(q, k, v, mask, rate, int(seed))
    return out, lse.detach()


def dump_keep_mask(B, H, T, seed, rate, device):
    """(B, H, T, T) bool: the keep mask the kernels apply for ``seed`` and
    ``rate`` (query rows against keys, per query head). The dump kernel on
    a CUDA device (one device kernel a call, writing the bool buffer
    itself), the plain hash on the CPU."""
    rate = float(rate)
    _check_dropout(rate, seed)
    device = torch.device(device)
    if device.type == "cpu":
        return keep_mask_ref(seed, B, H, T, rate, device)
    if device.type != "cuda":
        raise ValueError(f"dump_keep_mask runs on cpu or cuda, got {device}")
    keep = torch.empty((B, H, T, T), dtype=torch.bool, device=device)  # the kernel writes 0/1
    fn = load_dump_kernel()
    with torch.cuda.device(device):
        rc = fn(keep.data_ptr(), B, H, T, int(seed), keep_threshold(rate),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dump_keep_mask launch failed with CUDA error {rc}")
    tracing.count("dropout_mask")
    return keep
