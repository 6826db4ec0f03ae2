"""A/B on the card: the fused SwiGLU FFN kernel of one checkout against the
matmul chain (forward).

Port of scripts/ab_swiglu.py. The chain (``ops/_swiglu.py::swiglu_chain``,
two bf16 cuBLAS GEMMs and elementwise passes) writes the (M, 2F) hidden to
device memory between its two products; the hand-written kernel
(``ops/swiglu.py::swiglu``, ``csrc/swiglu_fwd.cu``) keeps it inside the
block. The fused plain version (``swiglu_fused_ref``, fp32 products) is
timed beside them.

Usage (by path, so that ``--root`` picks the package it times):

    python turkish_asr_torch/scripts/ab_swiglu.py [--root DIR] [M] [C] [F]

(defaults 6400 256 1024: the flagship FFN, d_model 256, d_ff 1024).
``--root`` is the root of a checkout of this repository (default: the one
this file is in); its ``turkish_asr_torch`` is imported and its kernel is
built there. Two trees compare in one call on one card: a parent commit
unpacked with ``git archive`` into a git-ignored directory, then parent,
this tree, this tree, parent.

It prints the card and the checkout, one line per row tile the checkout's
kernel offers, then the fused plain version's line and the chain's, each
as device ms per call (20 calls queued behind a spin kernel,
``ab_attention.device_ms``) and CUDA-event ms over 50 chained calls in
which each call's y is the next call's x (which also counts the host's
gaps), and last a JSON object of all times. It needs a CUDA card and
raises without one.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


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
    """Runs the A/B; returns {"root", "M", "C", "F", "tiles": {tm: {"ms",
    "chained_ms", "max_err"}}, "plain": {...}, "chain": {"ms",
    "chained_ms"}}, max_err against the chain."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose turkish_asr_torch is timed")
    for name, default in (("M", 6400), ("C", 256), ("F", 1024)):
        parser.add_argument(name, type=int, nargs="?", default=default)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        raise RuntimeError("the SwiGLU A/B times the CUDA kernel and needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    from turkish_asr_torch.ops import swiglu as sw
    from turkish_asr_torch.ops._swiglu import swiglu_chain, swiglu_fused_ref
    from turkish_asr_torch.scripts.ab_attention import device_ms
    if not Path(sw.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {sw.__file__}, not the checkout at {root}; run this "
                           f"file by its path, not with -m")
    M, C, F = args.M, args.C, args.F
    print(f"{torch.cuda.get_device_name(0)}; checkout {root}", flush=True)
    x, *rest = sw.args_from_numpy(*make_inputs(M, C, F), "cuda")
    y0 = swiglu_chain(x, *rest)
    result = {"root": str(root), "M": M, "C": C, "F": F, "tiles": {}}

    def times(fn):
        return {"ms": device_ms(lambda: fn(x, *rest)), "chained_ms": timeit_chained(fn, x, rest)}

    for tm in sw.ROW_TILES:
        def fused(a, *more, tm=tm):
            return sw.swiglu(a, *more, tm=tm)
        r = result["tiles"][tm] = dict(times(fused), max_err=_max_err(fused(x, *rest), y0))
        print(f"cuda tm={tm:3d}: device {r['ms']:.4f} ms, chained {r['chained_ms']:.4f} ms "
              f"(max err vs chain {r['max_err']:.2e})", flush=True)
    r = result["plain"] = dict(times(swiglu_fused_ref),
                               max_err=_max_err(swiglu_fused_ref(x, *rest), y0))
    print(f"fused plain: device {r['ms']:.4f} ms, chained {r['chained_ms']:.4f} ms "
          f"(max err vs chain {r['max_err']:.2e})", flush=True)
    r = result["chain"] = times(swiglu_chain)
    print(f"chain: device {r['ms']:.4f} ms, chained {r['chained_ms']:.4f} ms M={M} C={C} F={F}",
          flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
