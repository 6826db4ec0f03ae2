"""A/B on the card: the bias epilogue against the plain chain it replaces.

The kernel (``ops/bias_act.py``, ``csrc/bias_act.cu``) adds a product's fp32
bias, rounds to bf16 and applies the call site's tail in one pass; the plain
chain (``bias_act_plain``) is the upcast, the broadcast fp32 add, the
downcast and the tail's own kernels. No library call computes the same
function, so there is no library yardstick.

Usage:

    python -m turkish_asr_torch.scripts.ab_bias_act [--host] [--forward]

One JSON line for each site of ``SITES``: the shapes of the
``conformer_l.transcribe_24_32s`` cell's forward (B=32 rows of 32 s, T'=801,
d 512), of the ``flagship.transcribe_16_32s`` cell's (B=16 rows of 24
and 32 s, d 256, SiLU subsample, an odd depthwise kernel) and of the
``fastconformer_xxl.longform_180_240s`` cell's (B=4 rows of 256 s, T'=3201,
d 1024: the 8x subsample's ReLU planes and its depthwise convolutions'
bias alone, rows of d 1024, 4096 and 1025, the depthwise kernel of 9);
seeded inputs, a ragged mask with rows of 3/4 to all of their frames valid.
Each line holds the largest distance of the kernel from the plain chain in
bf16 ulps, device ms a call of each (``ab_attention.device_ms``: 20 calls
queued behind a spin kernel), the bound (bytes read and written once, over
3.35 TB/s) and the bytes. With ``--host``: the host microseconds a call of
the eager kernel path, of the op ``torch.ops.turkish_asr_torch.bias_act``
and of the plain chain, at a small shape queued behind a spin kernel. With
``--forward``: one Conformer (L) forward at the cell's shape under
torch.profiler through the kernel and through the plain chain (device ms
and operations, and the kernel's own ms and launches). It needs a CUDA card
and raises without one.
"""

import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from turkish_asr_torch.ops.bias_act import bias_act, bias_act_op, bias_act_plain
from turkish_asr_torch.scripts.ab_attention import _spin_cycles_per_ms, device_ms

PEAK_BYTES = 3.35e12
B, T, D = 32, 801, 512
M = B * T
FB, FD = 16, 256  # the flagship cell's batch and width
XB, XD, XT, XC = 4, 1024, 3201, 256  # FastConformer XXL's: batch, width, T', subsample channels
XM = XB * XT
# site: (tail, x's shape, dim, the depthwise kernel of bn_silu's x: a
# depthwise convolution's output, of (B, D, T + 1) with its first frame
# skipped for the even kernel)
SITES = {"subsample1_relu": ("relu", (B, D, 1601, 40), 1, None),
         "subsample2_relu": ("relu", (B, D, 801, 20), 1, None),
         "ff_linear1_silu": ("silu", (M, 4 * D), -1, None),
         "proj_none": ("none", (M, D), -1, None),
         "fc_none": ("none", (M, 1000), -1, None),
         "pw1_glu_mask": ("glu_mask", (M, 2 * D), -1, None),
         "dw_bn_silu": ("bn_silu", (B, D, T), 1, 32),
         "flagship_subsample1_silu_24s": ("silu", (FB, FD, 1201, 40), 1, None),
         "flagship_subsample1_silu": ("silu", (FB, FD, 1601, 40), 1, None),
         "flagship_subsample2_silu": ("silu", (FB, FD, 801, 20), 1, None),
         "flagship_proj_none": ("none", (FB * T, FD), -1, None),
         "flagship_ff_none": ("none", (FB * T, 4 * FD), -1, None),
         "flagship_pw1_glu_mask": ("glu_mask", (FB * T, 2 * FD), -1, None),
         "flagship_dw_bn_silu": ("bn_silu", (FB, FD, T), 1, 31),
         "xxl_subsample1_relu": ("relu", (XB, XC, 4 * XT - 3, 40), 1, None),
         "xxl_subsample2_dw_none": ("none", (XB, XC, 2 * XT - 1, 20), 1, None),
         "xxl_subsample2_pw_relu": ("relu", (XB, XC, 2 * XT - 1, 20), 1, None),
         "xxl_subsample3_dw_none": ("none", (XB, XC, XT, 10), 1, None),
         "xxl_subsample3_pw_relu": ("relu", (XB, XC, XT, 10), 1, None),
         "xxl_proj_none": ("none", (XM, XD), -1, None),
         "xxl_ff_linear1_silu": ("silu", (XM, 4 * XD), -1, None),
         "xxl_fc_none": ("none", (XM, 1025), -1, None),
         "xxl_pw1_glu_mask": ("glu_mask", (XM, 2 * XD), -1, None),
         "xxl_dw_bn_silu": ("bn_silu", (XB, XD, XT), 1, 9)}


def inputs(tail, shape, dim, device, seed=0, kernel=32):
    """(x, bias, mask, bn) of a site, seeded: x bf16 as a product leaves it
    (bn_silu's from a depthwise convolution of ``kernel``)."""
    g = torch.Generator().manual_seed(seed)
    width = shape[-1] if tail == "glu_mask" else shape[dim]
    bias = (torch.rand(width, generator=g) - 0.5).to(device)
    mask = bn = None
    if tail == "bn_silu":
        Bx, C, Tx = shape
        # the product as the model makes it: a depthwise convolution of a
        # (B, T, C) tensor seen as (B, C, T), its first frame dropped
        h = torch.randn(Bx, Tx, C, generator=g).to(device, torch.bfloat16)
        w = (0.1 * torch.randn(C, 1, kernel, generator=g)).to(device, torch.bfloat16)
        x = F.conv1d(h.transpose(1, 2), w, padding=kernel // 2, groups=C)
        x = x[..., 1:] if kernel % 2 == 0 else x
        bn = torch.nn.BatchNorm1d(C).to(device)
        with torch.no_grad():
            bn.running_mean.copy_(0.2 * torch.randn(C, generator=g))
            bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
            bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
            bn.bias.copy_(0.2 * torch.randn(C, generator=g))
        return x, bias, mask, bn
    x = torch.randn(shape, generator=g).to(device, torch.bfloat16)
    if tail == "glu_mask":
        rows = shape[0] // T if shape[0] % T == 0 else shape[0]
        frames = T if shape[0] % T == 0 else 1
        valid = np.random.default_rng(seed).integers(3 * frames // 4, frames + 1, rows)
        mask = (torch.arange(frames)[None, :] < torch.from_numpy(valid)[:, None])
        mask = mask.reshape(shape[:-1]).to(device)
    return x, bias, mask, bn


def ulps(a, b):
    """The largest distance of two bf16 tensors in bf16 ulps (by their bit
    patterns, ordered so that neighbouring floats differ by one)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def nbytes(tail, x):
    n = x.numel()
    if tail == "glu_mask":
        return 2 * n + 2 * (n // 2) + n // x.shape[-1] + 4 * x.shape[-1]
    if tail == "bn_silu":
        return 4 * n + 5 * 4 * x.shape[1]
    return 4 * n + 4 * x.shape[1 if x.dim() == 4 else -1]


def _bn_params(bn):
    return None if bn is None else (bn.running_mean, torch.rsqrt(bn.running_var + bn.eps),
                                    bn.weight, bn.bias)


def site(name, device, timed=True):
    """The JSON-able numbers of one site of ``SITES``."""
    tail, shape, dim, kernel = SITES[name]
    x, bias, mask, bn = inputs(tail, shape, dim, device, kernel=kernel or 32)
    with torch.no_grad():
        want = bias_act_plain(x, bias, torch.bfloat16, tail, dim, mask, _bn_params(bn))
        got = bias_act(x.clone(), bias, torch.bfloat16, tail, dim=dim, mask=mask, bn=bn)
        out = {"site": name, "tail": tail, "shape": list(x.shape),
               "ulps": ulps(got, want), "equal": bool(torch.equal(got, want)),
               "bytes": nbytes(tail, x),
               "bound_ms": 1e3 * nbytes(tail, x) / PEAK_BYTES, "bound_by": "bytes"}
        if timed:
            out["ms"] = device_ms(lambda: bias_act(x, bias, torch.bfloat16, tail, dim=dim,
                                                   mask=mask, bn=bn))
            out["plain_ms"] = device_ms(lambda: bias_act_plain(
                x, bias, torch.bfloat16, tail, dim, mask, _bn_params(bn)))
    return out


def host_us(fn, calls=100):
    """Host microseconds to enqueue one call of ``fn``, behind a spin kernel
    that keeps the card from holding the host back."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50 * _spin_cycles_per_ms()))
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - start) / calls
    torch.cuda.synchronize()
    return us


def host(device, rounds=7):
    """Host us a call of each path for each tail at a small shape (64 rows of
    512; bn_silu (2, 512, 33)): the median of ``rounds`` rounds, the three
    paths in turn within each (the card's host is shared, so one reading
    moves by tens of percent)."""
    rows = {}
    for tail in ("none", "silu", "glu_mask", "bn_silu"):
        dim = 1 if tail == "bn_silu" else -1
        shape = (2, D, 33) if tail == "bn_silu" else (64, 2 * D if tail == "glu_mask" else D)
        x, bias, mask, bn = inputs(tail, shape, dim, device)
        paths = {
            "kernel_us": lambda: bias_act(x, bias, torch.bfloat16, tail, dim=dim, mask=mask, bn=bn),
            "op_us": lambda: bias_act_op(x, bias, tail, dim, mask,
                                         *(_bn_params(bn) or (None,) * 4)),
            "plain_us": lambda: bias_act_plain(x, bias, torch.bfloat16, tail, dim, mask,
                                               _bn_params(bn))}
        got = {k: [] for k in paths}
        with torch.inference_mode():
            for _ in range(rounds):
                for k, fn in paths.items():
                    got[k].append(host_us(fn))
        rows[tail] = {k: statistics.median(v) for k, v in got.items()}
    return rows


def forward(device):
    """One Conformer (L) bf16 forward at the cell's shape (B=32 rows of 32 s,
    seeded weights and features) under torch.profiler, through the kernel
    and through the plain chain: device ms and operations of the whole
    forward, and the kernel's own ms and launches."""
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops import bias_act as ba

    cfg = ModelConfig(n_mels=80, d_model=D, n_heads=8, n_blocks=17, n_classes=1000,
                      conv_kernel_size=32, block="conformer")
    model = init_model(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn(B, 3201, 80, generator=torch.Generator().manual_seed(1)).to(device)
    lens = torch.full((B,), 3201, device=device)
    out = {}
    for path in ("kernel", "plain"):
        with mock.patch.object(ba, "kernel_takes", ba.kernel_takes if path == "kernel"
                               else lambda *a: False), torch.inference_mode():
            model(x, lens, torch.bfloat16)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                model(x, lens, torch.bfloat16)
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in events if "bias_act" in e.key]
        out[path] = {"device_ms": sum(e.self_device_time_total for e in events) / 1e3,
                     "device_ops": sum(e.count for e in events),
                     "bias_act_ms": sum(e.self_device_time_total for e in ours) / 1e3,
                     "bias_act_launches": sum(e.count for e in ours)}
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("ab_bias_act needs a CUDA card")
    device = torch.device("cuda")
    for name in SITES:
        print(json.dumps(site(name, device)), flush=True)
        torch.cuda.empty_cache()
    if "--host" in argv:
        print(json.dumps({"host_us": host(device)}), flush=True)
    if "--forward" in argv:
        print(json.dumps({"forward": forward(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
