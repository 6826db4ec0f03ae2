"""A/B on the card: the fused SwiGLU FFN kernel against the matmul chain
(forward).

Port of scripts/ab_swiglu.py. The chain (``ops/_swiglu.py::swiglu_chain``,
two bf16 cuBLAS GEMMs and elementwise passes) writes the (M, 2F) hidden to
device memory between its two products; the hand-written kernel
(``ops/swiglu.py::swiglu``, ``csrc/swiglu_fwd.cu``) keeps it inside the
block. The fused plain version (``swiglu_fused_ref``, fp32 products) is
timed beside them. Each time is CUDA events over n = 50 calls in which
each call's y is the next call's x, after warm-up, divided by n.

Usage: python -m turkish_asr_torch.scripts.ab_swiglu [M] [C] [F]
(defaults 6400 256 1024: the flagship FFN, d_model 256, d_ff 1024). It
prints one line per row tile the kernel offers, then the fused plain
version's line and the chain's. It needs a CUDA card and raises without
one.
"""

import sys

import numpy as np
import torch

from turkish_asr_torch.ops._swiglu import swiglu_chain, swiglu_fused_ref
from turkish_asr_torch.ops.swiglu import ROW_TILES, args_from_numpy, swiglu


def make_inputs(M, C, F):
    """The JAX script's draws (scripts/ab_swiglu.py:92-100), in its order
    from ``default_rng(0)``, as numpy fp32 before the rounding to bf16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, 2 * F)) * 0.05).astype(np.float32)
    b1 = np.zeros((1, 2 * F), np.float32)
    w2 = (rng.standard_normal((F, C)) * 0.05).astype(np.float32)
    b2 = np.zeros((1, C), np.float32)
    return x, w1, b1, w2, b2


def timeit_chained(fn, x, args, n=50, warmup=3):
    """ms per call of ``fn(x, *args)`` over n calls, each call's output the
    next call's x, by CUDA events after ``warmup`` calls."""
    y = x
    for _ in range(warmup):
        y = fn(y, *args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    y = x
    start.record()
    for _ in range(n):
        y = fn(y, *args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def main(argv=None):
    """Runs the A/B; returns {"M", "C", "F", "tiles": {tm: (ms, max err vs
    chain)}, "plain": (ms, max err vs chain), "chain_ms"}."""
    argv = sys.argv[1:] if argv is None else argv
    M = int(argv[0]) if len(argv) > 0 else 6400
    C = int(argv[1]) if len(argv) > 1 else 256
    F = int(argv[2]) if len(argv) > 2 else 1024
    if not torch.cuda.is_available():
        raise RuntimeError("the SwiGLU A/B times the CUDA kernel and needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    x, *args = args_from_numpy(*make_inputs(M, C, F), "cuda")
    y0 = swiglu_chain(x, *args)
    result = {"M": M, "C": C, "F": F, "tiles": {}}
    for tm in ROW_TILES:
        def fused(a, *rest, tm=tm):
            return swiglu(a, *rest, tm=tm)
        err = _max_err(fused(x, *args), y0)
        t = timeit_chained(fused, x, args)
        result["tiles"][tm] = (t, err)
        print(f"cuda tm={tm:3d}: {t:.4f} ms (max err vs chain {err:.2e})", flush=True)
    err = _max_err(swiglu_fused_ref(x, *args), y0)
    t = timeit_chained(swiglu_fused_ref, x, args)
    result["plain"] = (t, err)
    print(f"fused plain: {t:.4f} ms (max err vs chain {err:.2e})", flush=True)
    result["chain_ms"] = timeit_chained(swiglu_chain, x, args)
    print(f"chain: {result['chain_ms']:.4f} ms M={M} C={C} F={F}", flush=True)
    return result


if __name__ == "__main__":
    main()
