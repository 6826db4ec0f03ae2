"""Smoke run of turkish_asr_torch on one CUDA card: `python3 chip_smoke.py`.

Three phases; any failure raises and the script exits non-zero.

1. Setup: prints the card's name and power limit (nvidia-smi) and builds
   the CUDA kernel from turkish_asr_torch/csrc with nvcc.
2. Kernel: the flash-attention kernel against its plain PyTorch version on
   the card, B=4, H=4, D=64, T' in {26, 201, 601, 801}, Kh in {1, 4},
   ragged lengths with a length-0 row, bf16 and fp32 inputs. Tolerances:
   fp32 inputs 1e-4 abs on out and lse; bf16 inputs 2e-2 abs on out and
   1e-3 on lse (both round the normalized p to bf16 before p @ v, but the
   row sums are taken in another order, so a p next to a rounding boundary
   may round the other way). Median CUDA-event times of both.
3. Slice: a flagship-width model (80 mels, d_model 256, 4 heads, 8 blocks,
   56 classes) with seeded random weights, saved as a reference-layout .pt
   and served by turkish_asr_torch.serve.server on 127.0.0.1; /health,
   three single-file requests (1 s, 8 s, 24 s), one with timestamps and one
   3-file batch. The kernel must have launched 8 times per forward. Then
   the served bf16 logits of the 8 s input are held against the same model
   with attention routed through the plain version, and a 1 s input in
   fp32 on the card against the CPU.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import uuid
from unittest import mock

import numpy as np
import torch

SR = 16000
KERNEL_SHAPES = dict(B=4, H=4, D=64, T=(26, 201, 601, 801), Kh=(1, 4))
TOLERANCES = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}  # (out, lse)


def _median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase():
    from turkish_asr_torch.ops.flash_attention import flash_attention
    from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref

    gen = torch.Generator().manual_seed(0)
    B, H, D = KERNEL_SHAPES["B"], KERNEL_SHAPES["H"], KERNEL_SHAPES["D"]
    max_err, headline = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        for Kh in KERNEL_SHAPES["Kh"]:
            for T in KERNEL_SHAPES["T"]:
                q = torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                k = torch.randn(B, Kh, T, D, generator=gen).to("cuda", dtype)
                v = torch.randn(B, Kh, T, D, generator=gen).to("cuda", dtype)
                lens = torch.tensor([T, (2 * T) // 3, 0, 1])
                mask = (torch.arange(T)[None, :] < lens[:, None]).cuda()
                out, lse = flash_attention(q, k, v, mask)
                ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, mask)
                torch.cuda.synchronize()
                if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                    raise AssertionError(f"non-finite kernel output at {dtype} Kh={Kh} T={T}")
                err_o = (out - ref_out).abs().max().item()
                err_l = (lse - ref_lse).abs().max().item()
                tol_o, tol_l = TOLERANCES[dtype]
                if err_o > tol_o or err_l > tol_l:
                    raise AssertionError(f"kernel disagrees at {dtype} Kh={Kh} T={T}: "
                                         f"out {err_o} (tol {tol_o}), lse {err_l} (tol {tol_l})")
                ms = _median_ms(lambda: flash_attention(q, k, v, mask))
                plain_ms = _median_ms(lambda: flash_attention_fwd_ref(q, k, v, mask))
                print(f"kernel {str(dtype)[6:]} B={B} H={H} Kh={Kh} T'={T} D={D}: "
                      f"max|out-ref|={err_o:.3e} max|lse-ref|={err_l:.3e} "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
                max_err = max(max_err, err_o, err_l)
                if dtype == torch.bfloat16 and Kh == 1 and T == max(KERNEL_SHAPES["T"]):
                    headline = (ms, plain_ms)
    return max_err, headline


def _multipart(files):
    boundary = uuid.uuid4().hex
    body = b""
    for field, name, content in files:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
                 f"filename=\"{name}\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
        body += content + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * (200 + 60 * np.floor(t * 4)) * t)
    return (x + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


def _post(url, files):
    body, ctype = _multipart(files)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, payload = resp.status, json.loads(resp.read())
    return status, payload, (time.perf_counter() - start) * 1000


def slice_phase(workdir):
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.models import attention
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref
    from turkish_asr_torch.ops.flash_attention import flash_attention
    from turkish_asr_torch.serve.server import ASRService, ServerConfig, make_stdlib_server

    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    pt = os.path.join(workdir, "flagship.pt")
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"n_mel_channels": 80, "d_model": 256, "n_heads": 4,
                           "n_blocks": 8, "dropout": 0.0}}, pt)
    wav = {}
    for name, seconds, seed in (("s1", 1, 1), ("s8", 8, 2), ("s24", 24, 3),
                                ("b3", 3, 4), ("b35", 3.5, 5), ("b4", 4, 6)):
        wav[name] = os.path.join(workdir, f"{name}.wav")
        write_wav(wav[name], _tone(seconds, seed), SR)

    server_cfg = ServerConfig()
    server_cfg.MODEL_PATH = pt
    start = time.perf_counter()
    service = ASRService(server_cfg, warmup=True, device="cuda")
    print(f"service ready (load + warmup) in {time.perf_counter() - start:.3f} s", flush=True)
    if service.asr is None:
        raise AssertionError("the service did not load the model")
    server = make_stdlib_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def read(name):
        with open(wav[name], "rb") as f:
            return f.read()

    try:
        flash_attention.launches = 0
        forwards = 0
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health["model_loaded"] is not True or health["device"] != "cuda":
            raise AssertionError(f"bad /health: {resp.status} {health}")
        for name in ("s1", "s8", "s24"):
            status, payload, ms = _post(base + "/transcribe", [("file", name + ".wav", read(name))])
            forwards += 1
            if status != 200 or not isinstance(payload.get("text"), str):
                raise AssertionError(f"/transcribe {name}: {status} {payload}")
            print(f"POST /transcribe {name}: {ms:.2f} ms (server {payload['duration_ms']:.2f} ms)"
                  f" text={payload['text'][:40]!r}", flush=True)
        status, payload, ms = _post(base + "/transcribe?timestamps=1",
                                    [("file", "s8.wav", read("s8"))])
        forwards += 1
        if status != 200 or not isinstance(payload.get("text"), str) \
                or not isinstance(payload.get("segments"), list):
            raise AssertionError(f"/transcribe?timestamps=1: {status} {payload}")
        print(f"POST /transcribe?timestamps=1 s8: {ms:.2f} ms, "
              f"{len(payload['segments'])} segments", flush=True)
        status, payload, ms = _post(base + "/transcribe/batch",
                                    [("files", n + ".wav", read(n)) for n in ("b3", "b35", "b4")])
        forwards += 1  # all three fall in the 4 s bucket: one batched forward
        results = payload.get("results") or []
        if status != 200 or len(results) != 3 or any(
                r["error"] is not None or not isinstance(r["text"], str) for r in results):
            raise AssertionError(f"/transcribe/batch: {status} {payload}")
        print(f"POST /transcribe/batch 3 files: {ms:.2f} ms", flush=True)
        launches = flash_attention.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if launches < cfg.n_blocks * forwards:
        raise AssertionError(f"kernel launched {launches} times over {forwards} forwards; "
                             f"expected at least {cfg.n_blocks} per forward")
    print(f"kernel launches on the served path: {launches} over {forwards} forwards", flush=True)

    # Served (kernel) logits vs the same model with the plain attention.
    asr = service.asr
    waveform = _tone(8, 2)
    served, n = asr._forward_padded(waveform)
    with mock.patch.object(attention, "flash_attention", flash_attention_fwd_ref):
        plain, _ = asr._forward_padded(waveform)
        asr.compute_dtype = torch.float32
        plain_fp32, _ = asr._forward_padded(waveform)
        asr.compute_dtype = torch.bfloat16
    served, plain, plain_fp32 = served[:n], plain[:n], plain_fp32[:n]
    if not (np.isfinite(served).all() and served.shape == (n, cfg.n_classes)):
        raise AssertionError(f"served logits: shape {served.shape}, finite "
                             f"{np.isfinite(served).all()}")
    diff = float(np.abs(served - plain).max())
    bf16_noise = float(np.abs(plain - plain_fp32).max())
    agree = float((served.argmax(-1) == plain.argmax(-1)).mean())
    print(f"8 s input, {n} frames: max|kernel - plain| = {diff:.4e} (bf16 logits); "
          f"max|plain bf16 - plain fp32| = {bf16_noise:.4e}; argmax agreement {agree:.4f}",
          flush=True)
    # Kernel and plain path differ only in summation order; the served
    # logits may differ from the plain path's by no more than bf16 itself
    # moves them from fp32.
    if diff > bf16_noise or agree < 0.99:
        raise AssertionError("served logits disagree with the plain path")

    # fp32 on the card (kernel) vs fp32 on the CPU (plain path), 1 s input.
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    x = torch.from_numpy(_tone(1, 7))[None]
    lens = torch.tensor([x.shape[1]], dtype=torch.int32)
    with torch.inference_mode():
        outs = []
        for dev in ("cuda", "cpu"):
            m = model.to(dev)
            feats, fl = log_mel_spectrogram(x.to(dev), lens.to(dev))
            outs.append(m(feats, fl, torch.float32).cpu().numpy())
    err_cpu = float(np.abs(outs[0] - outs[1]).max())
    print(f"1 s input fp32: max|card - cpu| = {err_cpu:.4e}", flush=True)
    if err_cpu > 1e-3:
        raise AssertionError("fp32 logits on the card disagree with the CPU")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import turkish_asr_torch  # noqa: F401 — fails outside a checkout of the repo
    from turkish_asr_torch.ops import _build
    from turkish_asr_torch.ops.flash_attention import KERNEL_SOURCES, load_kernel

    # Full fp32 for the fp32 comparisons (cuDNN convolutions default to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    start = time.perf_counter()
    load_kernel()
    print(f"kernel build + load: {time.perf_counter() - start:.3f} s "
          f"({_build.library_path('flash_attention_fwd', KERNEL_SOURCES)})", flush=True)

    max_err, (ms, plain_ms) = kernel_phase()
    with tempfile.TemporaryDirectory() as workdir:
        launches = slice_phase(workdir)

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "turkish_asr_torch/csrc/flash_attention_fwd.cu",
        "replaces": "turkish_asr_tpu/ops/_flash_attention_impl.py:244",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
