"""Times the CTC kernels of one checkout on the card.

Usage (by path, so that ``--root`` picks the package it times):

    python turkish_asr_torch/scripts/ab_ctc.py [--root DIR]

``--root`` is the root of a checkout of this repository (default: the one
this file is in); its ``turkish_asr_torch`` is imported and its kernels are
built there. Two trees compare in one call on one card: a parent commit
unpacked with ``git archive`` into a git-ignored directory, then parent,
this tree, this tree, parent.

For each shape it times one forward of the checkout's
``ops/ctc.py::CTCNegLogLikelihood`` (what ``ctc_loss`` runs before its
reduction: in older trees also the topology kernels) and one backward
(the autograd backward of that loss: the gradient kernel and whatever the
wrapper launches around it), each as device ms per call (20 calls queued
behind a spin kernel, ``ab_attention.device_ms``) and over 20 chained calls
(``ab_attention.chained_ms``, which also counts the host's gaps), and under
torch.profiler the device kernels a call launches and the CTC kernel's own
ms. Beside them ``torch.nn.functional.ctc_loss`` (reduction none,
zero_infinity) and its gradient through autograd, the same ways. The
shapes are chip_smoke.py's CTC phase: B=32, T' in {200, 800}, L in {64,
512}, V in {56, 1000, 32768}, ragged lengths and a dummy row; the training
step's (T'=200, L=64, V=56) first. The last line is a JSON object of all
times. It needs a CUDA card and raises without one.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

MAIN = dict(B=32, T=200, L=64, V=56)  # a training step's CTC shape
GRID = dict(B=32, T=(200, 800), L=(64, 512), V=(56, 1000, 32768))
CTC_KERNELS = ("ctc_fwd_kernel", "ctc_bwd_kernel")


def shapes():
    yield MAIN
    for T in GRID["T"]:
        for L in GRID["L"]:
            for V in GRID["V"]:
                shape = dict(B=GRID["B"], T=T, L=L, V=V)
                if shape != MAIN:
                    yield shape


def ctc_inputs(B, T, L, V, seed=0):
    """log-probs (B, T, V), targets (B, L) int32, input and target lengths
    (B,) int32 (the trainer's types) and a cotangent (B,), on the card,
    from a seeded generator there: lengths in [T/2, T] and [1, L], the last
    row the collate's dummy (1 frame, no target)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, device="cuda", generator=gen), -1)
    tg = torch.randint(1, V, (B, L), device="cuda", generator=gen, dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=gen, dtype=torch.int32)
    tl = torch.randint(1, L + 1, (B,), device="cuda", generator=gen, dtype=torch.int32)
    il[-1], tl[-1] = 1, 0
    cot = torch.rand(B, device="cuda", generator=gen)
    return lp, tg, il, tl, cot


def kernel_stats(fn, calls=20):
    """(device kernels a call launches, ms a call of the kernels named in
    CTC_KERNELS, total kernel ms a call), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    count, own, total = 0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += e.count
        total += e.self_device_time_total / 1e3
        if any(name in e.key for name in CTC_KERNELS):
            own += e.self_device_time_total / 1e3
    return count / calls, own / calls, total / calls


def calls_of(fn_class, lp, tg, il, tl, cot):
    """(forward, backward) callables of a tree's CTCNegLogLikelihood."""
    x = lp.detach().requires_grad_(True)
    nll = fn_class.apply(x, tg, il, tl, 0)

    def forward():
        with torch.no_grad():
            return fn_class.apply(lp, tg, il, tl, 0)

    return forward, lambda: torch.autograd.grad(nll, x, cot, retain_graph=True)


def library_calls(lp, tg, il, tl, cot):
    """(forward, backward) of torch.nn.functional.ctc_loss on the same
    inputs: the yardstick, never called by the port."""
    import torch.nn.functional as F
    x = lp.detach().requires_grad_(True)

    def call():
        return F.ctc_loss(x.transpose(0, 1), tg, il, tl, blank=0, reduction="none",
                          zero_infinity=True)

    loss = call()

    def forward():
        with torch.no_grad():
            return call()

    return forward, lambda: torch.autograd.grad(loss, x, cot, retain_graph=True)


def time_shape(fn_class, timing, shape):
    lp, tg, il, tl, cot = ctc_inputs(**shape)
    row = {}
    for prefix, (fwd, bwd) in (("", calls_of(fn_class, lp, tg, il, tl, cot)),
                               ("library_", library_calls(lp, tg, il, tl, cot))):
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            launches, own, total = kernel_stats(fn)
            row[prefix + name] = {"ms": timing.device_ms(fn), "chained_ms": timing.chained_ms(fn),
                                  "kernel_ms": own, "kernels_ms": total,
                                  "device_kernels": launches}
    del lp
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose turkish_asr_torch is timed")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        raise RuntimeError("ab_ctc times the CUDA kernels and needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    from turkish_asr_torch.ops import ctc
    from turkish_asr_torch.scripts import ab_attention as timing
    if not Path(ctc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ctc.__file__}, not the checkout at {root}; run this "
                           f"file by its path, not with -m")
    print(f"{torch.cuda.get_device_name(0)}; checkout {root}", flush=True)
    result = {}
    for shape in shapes():
        label = "B={B} T'={T} L={L} V={V}".format(**shape)
        row = result[label] = time_shape(ctc.CTCNegLogLikelihood, timing, shape)
        for name in ("fwd", "bwd", "library_fwd", "library_bwd"):
            r = row[name]
            print(f"{label} {name}: device {r['ms']:.4f} ms, chained {r['chained_ms']:.4f} ms, "
                  f"{r['device_kernels']:.0f} device kernels a call ({r['kernels_ms']:.4f} ms; "
                  f"CTC kernel {r['kernel_ms']:.4f} ms)", flush=True)
    print(json.dumps({"root": str(root), "times": result}))
    return result


if __name__ == "__main__":
    main()
