"""Fused SwiGLU FFN forward: the dispatching wrapper.

Counterpart of scripts/ab_swiglu.py ``swiglu_pallas`` (:67-85). Tensors on
the CPU go to the plain version (``_swiglu.py::swiglu_fused_ref``); CUDA
tensors launch the hand-written Hopper kernel (``csrc/swiglu_fwd.cu``) or
raise. Forward only, as the TPU kernel: an input that requires grad is
refused. ``swiglu.launches`` counts the kernel launches.

``swiglu_plan`` is the kernel's launch arithmetic, in Python so that the
CPU tests hold it: the grid, the thread-block cluster that splits F, the
shared memory and the copy path, which the kernel takes from it.
"""

import ctypes
import threading
from collections import namedtuple

import numpy as np
import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._swiglu import swiglu_fused_ref

SOURCES = ("swiglu_fwd.cu",)
ROW_TILES = (64, 128)  # rows a block owns (16 a warp); one kernel instance each
DEFAULT_TILE = 128  # the faster of the two at M=6400, C=256, F=1024 on the H100 (PERF.md)
MAX_C = 256  # y columns a warp holds
CHUNK = 32  # hidden units a block stages and multiplies at a time
STAGES = 3  # chunks in shared memory: two in flight while one is multiplied
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks of a cluster that split F (8: the portable most)
_count_lock = threading.Lock()

Plan = namedtuple("Plan", "grid cluster smem aligned")


def _check_shape(M, C, F, tm):
    if M < 1 or F < 1 or not 1 <= C <= MAX_C:
        raise ValueError(f"the kernel takes M >= 1, F >= 1 and 1 <= C <= {MAX_C}, "
                         f"got M={M}, C={C}, F={F}")
    if tm not in ROW_TILES:
        raise ValueError(f"tm must be one of {ROW_TILES}, got {tm}")


def swiglu_plan(M, C, F, tm, sms):
    """The launch of ``csrc/swiglu_fwd.cu`` for x (M, C) and F hidden
    units at ``tm`` rows a block on a card of ``sms`` SMs: ``grid``
    blocks, ``cluster`` of them on the same rows splitting F's 32-unit
    chunks, ``smem`` bytes of shared memory a block (the x tile of tm rows
    and STAGES w1 and w2 chunks in bf16, rows padded by 8 elements; the
    cluster's fp32 partial y reuses them), whether the ``aligned`` 16-byte
    copies serve (C % 8 == 0 and F % 8 == 0: every 16-byte group of a row
    lies inside C or F, and the value half of a w1 row starts at byte 2F;
    the wrapper also needs 16-byte aligned tensors). A block runs 2 tm
    threads. The kernel takes the grid and the bytes from here and refuses
    fewer bytes than it stages.

    A block takes an SM of its own (its shared memory), so the cluster is
    the fewest blocks that put a block on at least half of the card's SMs,
    and no more than there are chunks: beyond that, splitting F adds a
    second wave of blocks and the cluster's sum without shortening the
    first (on the H100 at M=6400, tm=128, clusters of 2 beat 4 and 1;
    PERF.md)."""
    _check_shape(M, C, F, tm)
    tiles, chunks = -(-M // tm), -(-F // CHUNK)
    cluster = next((s for s in CLUSTER_SIZES if 2 * tiles * s >= sms), CLUSTER_SIZES[-1])
    cluster = max(s for s in CLUSTER_SIZES if s <= min(cluster, chunks))
    smem = 2 * (tm * (MAX_C + 8) + STAGES * (MAX_C * (2 * CHUNK + 8) + CHUNK * (MAX_C + 8)))
    return Plan(tiles * cluster, cluster, smem, C % 8 == 0 and F % 8 == 0)


def load_kernel():
    fn = load_library("swiglu_fwd", SOURCES).swiglu_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


def _check(x, w1, b1, w2, b2, tm):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x must be (M, C), w1 (C, 2F) and w2 (F, C)")
    M, C = x.shape
    F = w2.shape[0]
    if w1.shape != (C, 2 * F) or w2.shape != (F, C):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not match x "
                         f"{tuple(x.shape)}: w1 must be (C, 2F) and w2 (F, C)")
    if b1.numel() != 2 * F or b1.shape[-1] != 2 * F or b2.numel() != C or b2.shape[-1] != C:
        raise ValueError(f"b1 {tuple(b1.shape)} must be (2F,) or (1, 2F) and b2 "
                         f"{tuple(b2.shape)} (C,) or (1, C), with F={F}, C={C}")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w2)):
        raise ValueError(f"x, w1 and w2 must be bf16, got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError(f"b1 and b2 must be fp32, got {b1.dtype}, {b2.dtype}")
    if any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise ValueError("swiglu is forward only (the TPU kernel has no backward); "
                         "an input requires grad")
    _check_shape(M, C, F, tm)  # the shapes and tiles the kernel takes, on the CPU too
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")


def swiglu(x, w1, b1, w2, b2, tm=DEFAULT_TILE):
    """y = bf16(bf16(silu(h1) * h2) @ w2 + b2) with h = x @ w1 + b1 in fp32.

    Args:
        x: (M, C) bf16 rows; any M >= 1 (every row is written).
        w1: (C, 2F) bf16, gate columns first; b1: (2F,) or (1, 2F) fp32.
        w2: (F, C) bf16; b2: (C,) or (1, C) fp32. C <= 256.
        tm: rows a block of the kernel owns, one of ``ROW_TILES`` (checked
            on the CPU too, where the plain version has no tiles).

    Returns:
        (M, C) bf16.
    """
    _check(x, w1, b1, w2, b2, tm)
    if x.device.type == "cpu":
        return swiglu_fused_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"swiglu runs on cpu or cuda tensors, got {x.device}")
    M, C = x.shape
    F = w2.shape[0]
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    b1, b2 = b1.reshape(-1).contiguous(), b2.reshape(-1).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = swiglu_plan(M, C, F, tm, sms)
    aligned = plan.aligned and all(t.data_ptr() % 16 == 0 for t in (x, w1, w2))
    y = torch.empty((M, C), dtype=torch.bfloat16, device=x.device)
    fn = load_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                y.data_ptr(), M, C, F, tm, plan.grid, plan.cluster, plan.smem, int(aligned),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swiglu_fwd launch failed with CUDA error {rc}")
    with _count_lock:
        swiglu.launches += 1
    return y


swiglu.launches = 0


def args_from_numpy(x, w1, b1, w2, b2, device):
    """The A/B's numpy fp32 draws as (x, w1, b1, w2, b2) tensors on
    ``device``: x, w1 and w2 rounded to bf16 to nearest even, as
    ``jnp.astype(jnp.bfloat16)`` rounds them; the biases stay fp32."""
    def bf16(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16).to(device)

    def fp32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return bf16(x), bf16(w1), fp32(b1), bf16(w2), fp32(b2)
