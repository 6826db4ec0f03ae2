"""Fused SwiGLU FFN forward: the dispatching wrapper.

Counterpart of scripts/ab_swiglu.py ``swiglu_pallas`` (:67-85). Tensors on
the CPU go to the plain version (``_swiglu.py::swiglu_fused_ref``); CUDA
tensors launch the hand-written Hopper kernel (``csrc/swiglu_fwd.cu``) or
raise. Forward only, as the TPU kernel: an input that requires grad is
refused. The counter ``swiglu_fwd`` of ``utils/tracing.py`` counts the
kernel launches.

``swiglu_plan`` is the kernel's launch arithmetic, in Python so that the
CPU tests hold it: the grid, the thread-block cluster (blocks splitting
F), the ring, the shared memory and the
copy path, which the kernel takes from it and checks.
"""

import ctypes
from collections import namedtuple

import numpy as np
import torch

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.ops._swiglu import swiglu_fused_ref
from turkish_asr_torch.utils import tracing

SOURCES = ("swiglu_fwd.cu",)
ROW_TILES = (64, 128)  # rows a block owns; one kernel instance each
# The row tile at C <= 256: at M=6400 and 25600 (C=256, F=1024) it took
# 0.0373 and 0.1183-0.1193 ms on the H100 against 64 rows' 0.0391-0.0394
# and 0.1476-0.1477 (ab_swiglu.py; PERF.md): 128 rows read each weight
# byte from L2 for twice the rows, and 64 rows at C <= 256 compute both
# warpgroups' column halves twice.
DEFAULT_TILE = 128
MAX_C = 512  # every d_model the repository's configurations use
# Each row tile's instance: the hidden units a chunk, the ring's 32 KB
# slots, and the widest C it takes. 128 rows: each consumer warpgroup owns
# 64 of them, y (64 x C fp32) in its registers; 64 rows: the two split y's
# columns (csrc/swiglu_fwd.cu).
INSTANCES = {128: dict(chunk=64, stages=4, max_c=256), 64: dict(chunk=128, stages=4, max_c=512)}
SLOT = 32768  # bytes of a ring slot
X_TILE = 65536  # bytes of the x tile: 128 x 256 or 64 x 512 bf16
G_TILES = 32768  # the g tiles: two buffers of 64 x 128 bf16
WARPGROUPS = 3  # two consumer warpgroups and a producer warpgroup a block
FSPLITS = (1, 2, 4, 8)  # blocks of a cluster that split F; 8 is the portable most
tracing.count("swiglu_fwd", 0)

Plan = namedtuple("Plan", "grid cluster smem aligned stages chunk groups")


def default_tile(C):
    """The row tile ``swiglu`` takes when none is given: DEFAULT_TILE where
    its instance takes C, else 64."""
    return DEFAULT_TILE if C <= INSTANCES[DEFAULT_TILE]["max_c"] else 64


def row_tiles(C):
    """The row tiles whose instance takes C columns."""
    return tuple(tm for tm in ROW_TILES if C <= INSTANCES[tm]["max_c"])


def _check_shape(M, C, F, tm):
    if M < 1 or F < 1 or not 1 <= C <= MAX_C:
        raise ValueError(f"the kernel takes M >= 1, F >= 1 and 1 <= C <= {MAX_C}, "
                         f"got M={M}, C={C}, F={F}")
    if tm not in ROW_TILES:
        raise ValueError(f"tm must be one of {ROW_TILES}, got {tm}")
    if C > INSTANCES[tm]["max_c"]:
        raise ValueError(f"tm={tm} takes C <= {INSTANCES[tm]['max_c']}, got C={C}; "
                         f"tm=64 takes C <= {MAX_C}")


def swiglu_plan(M, C, F, tm, sms, aligned=True):
    """The launch of ``csrc/swiglu_fwd.cu`` for x (M, C) and F hidden
    units at ``tm`` rows a block on a card of ``sms`` SMs: ``grid``
    blocks of ``groups`` warpgroups (two consumers and a TMA producer) in
    clusters of ``cluster`` blocks on the same rows that split F's
    ``chunk``-unit chunks; ``stages`` 32 KB ring slots, ``smem`` bytes of
    shared memory a block (the x tile, the ring, the g tiles, the barriers
    and the 1024-byte alignment; the partial y of an F split reuses them),
    and whether the ``aligned`` path serves: TMA needs C % 8 == 0 and F %
    8 == 0 (16-byte row strides of x, w2 and each half of w1) and 16-byte
    aligned tensors (``aligned=False`` says they are not); otherwise the
    producer copies the same tiles element by element. The kernel refuses
    any other plan.

    tm=128 (C <= 256) holds y for 64 rows a consumer warpgroup; tm=64 (C
    <= 512, Conformer-L's 512 included) shares 64 rows between the two,
    which split y's columns. A block takes an SM of its own (its shared
    memory), so the cluster is the fewest blocks that put a block on at
    least half of the card's SMs, and no more than there are chunks:
    beyond that, splitting F adds a second wave of blocks and the sum of
    the partial y's without shortening the first. (Clusters of two row
    tiles that shared each weight slot through TMA multicast measured 1-8%
    slower at every A/B shape on the H100, PERF.md, and were dropped.)"""
    _check_shape(M, C, F, tm)
    aligned = aligned and C % 8 == 0 and F % 8 == 0
    inst = INSTANCES[tm]
    tiles, chunks = -(-M // tm), -(-F // inst["chunk"])
    fits = [s for s in FSPLITS if s <= chunks]
    fsplit = next((s for s in fits if 2 * tiles * s >= sms), fits[-1])
    stages = inst["stages"]
    smem = X_TILE + stages * SLOT + G_TILES + 8 * (2 * stages + 1) + 1024
    return Plan(tiles * fsplit, fsplit, smem, aligned, stages, inst["chunk"], WARPGROUPS)


def load_kernel():
    fn = load_library("swiglu_fwd", SOURCES).swiglu_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


def _check(x, w1, b1, w2, b2, tm):
    """Raises on what the kernel does not take; returns the row tile."""
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
    tm = default_tile(C) if tm is None else tm
    _check_shape(M, C, F, tm)  # the shapes and tiles the kernel takes, on the CPU too
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")
    return tm


def swiglu(x, w1, b1, w2, b2, tm=None):
    """y = bf16(bf16(silu(h1) * h2) @ w2 + b2) with h = x @ w1 + b1 in fp32.

    Args:
        x: (M, C) bf16 rows; any M >= 1 (every row is written).
        w1: (C, 2F) bf16, gate columns first; b1: (2F,) or (1, 2F) fp32.
        w2: (F, C) bf16; b2: (C,) or (1, C) fp32. C <= 512.
        tm: rows a block of the kernel owns, one of ``row_tiles(C)``;
            None takes ``default_tile(C)`` (checked on the CPU too, where
            the plain version has no tiles).

    Returns:
        (M, C) bf16.
    """
    tm = _check(x, w1, b1, w2, b2, tm)
    if x.device.type == "cpu":
        return swiglu_fused_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"swiglu runs on cpu or cuda tensors, got {x.device}")
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    b1, b2 = b1.reshape(-1).contiguous(), b2.reshape(-1).contiguous()
    M, C = x.shape
    F = w2.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w1, w2))
    plan = swiglu_plan(M, C, F, tm, sms, aligned=aligned)
    y = torch.empty((M, C), dtype=torch.bfloat16, device=x.device)
    fn = load_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                y.data_ptr(), M, C, F, tm, plan.grid, plan.cluster, plan.stages, plan.chunk,
                plan.smem, int(plan.aligned), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swiglu_fwd launch failed with CUDA error {rc}")
    tracing.count("swiglu_fwd")
    return y


def args_from_numpy(x, w1, b1, w2, b2, device):
    """The A/B's numpy fp32 draws as (x, w1, b1, w2, b2) tensors on
    ``device``: x, w1 and w2 rounded to bf16 to nearest even, as
    ``jnp.astype(jnp.bfloat16)`` rounds them; the biases stay fp32."""
    def bf16(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16).to(device)

    def fp32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return bf16(x), bf16(w1), fp32(b1), bf16(w2), fp32(b2)
