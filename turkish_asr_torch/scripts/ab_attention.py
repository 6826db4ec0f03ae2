"""Times the flash-attention kernels of one checkout on the card, and
profiles the main path's attention share.

Usage (by path, so that ``--root`` picks the package it times):

    python turkish_asr_torch/scripts/ab_attention.py [--root DIR] [--profile | --dump | --served]

``--root`` is the root of a checkout of this repository (default: the one
this file is in); its ``turkish_asr_torch`` is imported and its kernels are
built there. So two trees compare in one call on one card, e.g. a parent
commit unpacked with ``git archive`` into a git-ignored directory:
parent, this tree, this tree, parent.

Without ``--profile`` it prints one line per shape: the forward and the
backward kernel (``ops/flash_attention.py`` ``_fwd`` and ``_bwd``), each
over 20 chained calls between two CUDA events after warm-up (which counts
the host's gaps where the wrapper's Python outlasts the kernel), and each
as device time per call: the same 20 calls queued behind a spin kernel,
so that the events time the kernels back to back. The shapes
are chip_smoke.py's attention phase (B=4, H=4, D=64, T' in {26, 201,
601, 801}, Kh in {1, 4}, bf16 and fp32, dropout 0 and 0.1) and the main
path's two (training B=32, T'=200, dropout 0.1; the long served bucket
B=16, T'=601; bf16 MQA). The last line is a JSON object of all times.

With ``--dump`` it times the dropout-mask dump instead
(``ops/flash_attention.py::dump_keep_mask``, ``csrc/dropout_mask.cu``) at
DUMP_SHAPES: chip_smoke.py's B=4, H=4, T'=801 and one dump past 2^31
elements; device and chained ms per call and, by torch.profiler, the
device kernels a call launches.

With ``--profile`` it runs the flagship model (80 mels, d_model 256, 4
heads MQA, 8 blocks, seeded random weights) and prints, for a bf16
training step (B=32 rows of 4-8 s, T' <= 200, dropout 0.1, SpecAugment,
per-block recomputation, AdamW) and for a bf16 forward of B=16 x 24 s:
the wall ms per step or forward (median of 10, host clock around work
ended by a synchronize), and under ``torch.profiler`` over 5 of them the
kernel launches, the device time, the attention kernels' device time and
share, and the device-busy share (device time over the profiled wall).
It needs a CUDA card and raises without one.

With ``--served`` it times the served forward (log-mel + the flagship
model in bf16 under ``torch.inference_mode``, as ``ASRInference`` runs it,
seeded random weights) at B=1 x 8 s and B=16 x 24 s: unprofiled wall ms,
median of 10 after warm-up, host clock around work ended by a
synchronize. Run with ``--root`` on a parent tree and without it in turns,
it compares the host cost of two versions of the model's Python (e.g. the
attention forward called through the ``torch.library`` op against a plain
ctypes call).
"""

import argparse
import functools
import json
import re
import statistics
import sys
import time
from pathlib import Path

import torch

# The attention shapes that chip_smoke.py checks and this script times: a
# sweep, and the main path's two (a training step, B=32 rows of 4-8 s,
# T' <= 200, dropout 0.1; the long served bucket, B=16 x 24 s, T'=601).
SWEEP = dict(B=4, H=4, D=64, T=(26, 201, 601, 801), Kh=(1, 4), rate=(0.0, 0.1))
MAIN_PATH = {"train": dict(B=32, H=4, Kh=1, T=200, D=64, rate=0.1),
             "serve": dict(B=16, H=4, Kh=1, T=601, D=64, rate=0.0)}
CALLS = 20
DUMP_SHAPES = ((4, 4, 801), (1, 1, 46341))  # (B, H, T'): the attention phase's; past 2^31 bytes
ATTENTION_KERNELS = ("flash_fwd_kernel", "flash_bwd_")  # in the attention kernels' names
SR = 16000


def chained_ms(fn, calls=CALLS, warmup=3):
    """ms per call over `calls` calls between two CUDA events, after warm-up:
    it also counts the host's gaps where a call's Python outlasts its
    kernels."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _shapes():
    for dtype in (torch.float32, torch.bfloat16):
        for Kh in SWEEP["Kh"]:
            for T in SWEEP["T"]:
                for rate in SWEEP["rate"]:
                    yield (f"{str(dtype)[6:]} B={SWEEP['B']} Kh={Kh} T'={T} rate={rate}",
                           dict(B=SWEEP["B"], H=SWEEP["H"], Kh=Kh, T=T, D=SWEEP["D"],
                                rate=rate, dtype=dtype))
    for where, shp in MAIN_PATH.items():
        yield (f"main path {where}: bf16 B={shp['B']} Kh={shp['Kh']} T'={shp['T']} "
               f"rate={shp['rate']}", dict(shp, dtype=torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms():
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def device_ms(fn, calls=CALLS, warmup=3):
    """Device ms per call over `calls` chained calls, with the host out of
    the way: a spin kernel holds the stream while the host enqueues them,
    so the two CUDA events around the calls time their kernels back to
    back. If the spin ends before the last call is queued, it is lengthened
    once; where the host still cannot get ahead (the call waits for the
    card, as ctc_loss reads its lengths back, or thousands of launches fill
    the launch queue), the kernels' own times from torch.profiler are
    summed instead (the median of three profiled runs: on the card the
    profiler now and then drops events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    spin_ms = 2.0 * (time.perf_counter() - start) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(2):
        held, begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        held.record()
        begin.record()
        for _ in range(calls):
            fn()
        end.record()
        queued_in_time = not held.query()
        end.synchronize()
        if queued_in_time:
            return begin.elapsed_time(end) / calls
        spin_ms *= 4
    return statistics.median(sum(kernel_split(fn, calls).values()) for _ in range(3))


def kernel_split(fn, calls=CALLS):
    """{kernel name: device ms per call} of the kernels ``fn`` launches, by
    torch.profiler (which on the card now and then drops events: a
    breakdown, not a time)."""
    split = {}
    for e in _key_averages(fn, calls):
        key = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
        name = re.search(r"^(\w+)\s*[<(]", key)
        name = name.group(1) if name else key
        split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return split


def device_kernels(fn, calls=CALLS):
    """{device kernel: launches a call} of ``fn``, by torch.profiler: the
    fullest of five profiled windows, since on the card the profiler now
    and then drops a window's events, or some of them (a dropped event
    shows as a fraction below the true count)."""
    windows = [{e.key: e.count / calls for e in _key_averages(fn, calls)} for _ in range(5)]
    return max(windows, key=lambda w: sum(w.values()))


def _key_averages(fn, calls):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def dump_times(fa):
    """{shape label: {"ms", "chained_ms", "device_kernels"}} of the
    checkout's dump at DUMP_SHAPES."""
    result = {}
    for B, H, T in DUMP_SHAPES:
        def dump(B=B, H=H, T=T):
            return fa.dump_keep_mask(B, H, T, 7, 0.1, "cuda")
        r = result[f"B={B} H={H} T'={T}"] = {
            "ms": device_ms(dump), "chained_ms": chained_ms(dump),
            "device_kernels": sum(device_kernels(dump).values())}
        print(f"dump B={B} H={H} T'={T}: device {r['ms']:.4f} ms, chained {r['chained_ms']:.4f} "
              f"ms, {r['device_kernels']:.2f} device kernels a call", flush=True)
        torch.cuda.empty_cache()
    return result


def attention_inputs(B, H, Kh, T, D, dtype):
    """q (B, H, T, D) and k, v (B, Kh, T, D) in dtype, g (B, H, T, D) fp32
    and a (B, T) key mask, on the card, drawn with numpy from seed T: row
    lengths in [T/2, T], the first row full and the last with no valid
    key. chip_smoke.py times the main path's shapes on the same inputs."""
    import numpy as np
    rng = np.random.default_rng(T)
    q = torch.from_numpy(rng.standard_normal((B, H, T, D), np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Kh, T, D), np.float32)).to("cuda", dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((B, H, T, D), np.float32)).cuda()
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, B))
    lens[0], lens[-1] = T, 0
    mask = (torch.arange(T)[None, :] < lens[:, None]).cuda()
    return q, k, v, g, mask


def kernel_times(fa):
    """{shape label: (forward ms, backward ms, forward device ms, backward
    device ms)} of the checkout's kernels."""
    result = {}
    for label, s in _shapes():
        q, k, v, g, mask = attention_inputs(*(s[k] for k in ("B", "H", "Kh", "T", "D", "dtype")))
        rate = s["rate"]
        out, _, m, l = fa._fwd(q, k, v, mask, rate, 5)
        delta = (g * out).sum(-1)
        calls = (lambda: fa._fwd(q, k, v, mask, rate, 5),
                 lambda: fa._bwd(q, k, v, mask, m, l, delta, g, rate, 5))
        result[label] = [chained_ms(fn) for fn in calls] + [device_ms(fn) for fn in calls]
        print("{}: forward {:.4f} ms, backward {:.4f} ms; device forward {:.4f} ms, backward "
              "{:.4f} ms".format(label, *result[label]), flush=True)
        if label.startswith("main path"):
            print("  by kernel (profiler): " + ", ".join(
                f"{name} {ms:.4f}" for fn in calls for name, ms in kernel_split(fn).items()),
                flush=True)
    return result


def _profiled(step, n=5):
    """(kernel launches, device ms, attention device ms, wall ms) per call
    of ``step`` over n calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    launches, device, attention = 0, 0.0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += evt.count
        device += evt.self_device_time_total / 1e3
        if any(name in evt.key for name in ATTENTION_KERNELS):
            attention += evt.self_device_time_total / 1e3
    return launches / n, device / n, attention / n, wall / n


def _wall_ms(step, n=10, warmup=3):
    for _ in range(warmup):
        step()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def _tone_batch(np, rng, B, seconds):
    lens = (np.asarray(seconds) * SR).astype(np.int32)
    wav = np.zeros((B, int(lens.max())), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / SR
        wav[i, :n] = 0.3 * np.sin(2 * np.pi * (200 + 10 * i) * t) + 0.03 * rng.standard_normal(n)
    return wav, lens


def profile_main_path():
    """The §5 profile of a flagship training step and a B=16 x 24 s forward."""
    import logging
    import types
    import numpy as np
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.train.optim import make_optimizer
    from turkish_asr_torch.train.trainer import Trainer

    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.1)
    model = init_model(cfg, torch.Generator().manual_seed(0)).cuda()
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer, schedule = make_optimizer(params, 1e-3, 1e-2, 1000, pct_start=0.1,
                                         gradient_clip=1.0, accumulation_steps=1)
    config = types.SimpleNamespace(no_remat=False, spec_augment_freq=27, spec_augment_time=100)
    trainer = Trainer(model, optimizer, schedule, config, logging.getLogger("ab_attention"),
                      device="cuda", compute_dtype=torch.bfloat16, augment=True)
    rng = np.random.default_rng(0)
    B = 32
    wav, lens = _tone_batch(np, rng, B, rng.uniform(4.0, 8.0, B))
    wav = np.pad(wav, ((0, 0), (0, 8 * SR - wav.shape[1])))  # the 8 s bucket: T' = 200
    tl = rng.integers(10, 64, B).astype(np.int32)
    batch = {"waveforms": wav, "wav_lengths": lens,
             "targets": rng.integers(1, 56, (B, 64)).astype(np.int32), "target_lengths": tl,
             "sample_mask": np.ones(B, np.float32)}
    seed = iter(range(10 ** 6))
    train = {"wall_ms": _wall_ms(lambda: trainer.train_step(batch, next(seed)))}
    train.update(zip(("launches", "device_ms", "attention_ms", "profiled_wall_ms"),
                     _profiled(lambda: trainer.train_step(batch, next(seed)))))

    model.eval()
    wav, lens = _tone_batch(np, rng, 16, [24.0] * 16)
    x, xl = torch.from_numpy(wav).cuda(), torch.from_numpy(lens).cuda()

    def forward():
        with torch.inference_mode():
            feats, fl = log_mel_spectrogram(x, xl)
            return model(feats, fl, torch.bfloat16)

    serve = {"wall_ms": _wall_ms(forward)}
    serve.update(zip(("launches", "device_ms", "attention_ms", "profiled_wall_ms"),
                     _profiled(forward)))
    for name, r in (("training step B=32 x 4-8 s", train), ("forward B=16 x 24 s", serve)):
        r["attention_share"] = r["attention_ms"] / r["device_ms"]
        r["busy"] = r["device_ms"] / r["profiled_wall_ms"]
        print(f"{name}: wall {r['wall_ms']:.3f} ms (median of 10); profiled: "
              f"{r['launches']:.0f} launches, device {r['device_ms']:.3f} ms, attention "
              f"{r['attention_ms']:.3f} ms ({100 * r['attention_share']:.1f}% of device time), "
              f"wall {r['profiled_wall_ms']:.3f} ms, device busy {r['busy']:.3f}", flush=True)
    return {"train": train, "serve": serve}


def served_forward_times():
    """Wall ms (median of 10) of the served bf16 forward at B=1 x 8 s and
    B=16 x 24 s."""
    import numpy as np
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    from turkish_asr_torch.models.conformer import ModelConfig, init_model

    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0)).cuda().eval()
    rng = np.random.default_rng(0)
    out = {}
    for B, seconds in ((1, 8.0), (16, 24.0)):
        wav, lens = _tone_batch(np, rng, B, [seconds] * B)
        x, xl = torch.from_numpy(wav).cuda(), torch.from_numpy(lens).cuda()

        def forward():
            with torch.inference_mode():
                feats, fl = log_mel_spectrogram(x, xl)
                return model(feats, fl, torch.bfloat16)

        key = f"B{B}x{seconds:g}s"
        out[key] = _wall_ms(forward)
        print(f"served forward {key}: wall {out[key]:.3f} ms (median of 10)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose turkish_asr_torch is timed")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="profile a training step and a long served forward instead")
    mode.add_argument("--dump", action="store_true",
                      help="time the dropout-mask dump kernel instead")
    mode.add_argument("--served", action="store_true",
                      help="time the served forward at B=1 x 8 s and B=16 x 24 s instead")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        raise RuntimeError("ab_attention times the CUDA kernels and needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    from turkish_asr_torch.ops import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fa.__file__}, not the checkout at {root}; run this "
                           f"file by its path, not with -m")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; checkout {root}", flush=True)
    if args.profile:
        key, result = "profile", profile_main_path()
    elif args.served:
        key, result = "served", served_forward_times()
    else:
        key, result = ("dump", dump_times(fa)) if args.dump else ("times", kernel_times(fa))
    print(json.dumps({"root": str(root), key: result}))
    return result


if __name__ == "__main__":
    main()
