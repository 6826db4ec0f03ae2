"""A/B on the card: the relative-position attention kernel against its plain
version and the best library composition.

The kernel (``ops/relpos_attention.py``, ``csrc/flash_attention_relpos_fwd.cu``)
keeps the scores on chip. The plain version (``_relpos_attention.py``)
materialises the (B, H, T, 2T-1) position scores and the (B, H, T, T)
scores in fp32. The library composition is what PyTorch alone does best:
the position term (q + v) p^T in bf16 over all 2T-1 distances, ESPnet's
pad-view-slice rel-shift, scaled and shifted by the key mask into a bf16
float ``attn_mask``, then ``scaled_dot_product_attention`` of q + u, k, v
with that mask (the port never calls it; it is the yardstick).

Usage:

    python -m turkish_asr_torch.scripts.ab_relpos [--d D] [B] [T ...]

(defaults D = 64, 32, 801 1601: Conformer (L)'s cell's batch of 32 s rows
and a 64 s row; ``--d 128 4 1601 2401 3201`` is FastConformer XXL's head
size at its long-form cell's batch of four 128-256 s rows). H = 8, bf16,
key lengths seeded in [3T/4, T]. For each T
it prints one JSON object: device ms a call of each (``ab_attention.device_ms``:
20 calls queued behind a spin kernel), the kernel's bound (6*B*H*T*T*D
flops at 989 TFLOP/s against its bytes at 3.35 TB/s, as
``asr_bench/relpos_counts.py`` counts them), the largest difference of the
kernel and of the library from the plain version, and the peak memory each
allocates. It needs a CUDA card and raises without one.
"""

import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from turkish_asr_torch.ops._relpos_attention import relpos_attention_ref
from turkish_asr_torch.ops.relpos_attention import relpos_attention
from turkish_asr_torch.scripts.ab_attention import device_ms

H = 8


def bound_ms(B, T, D=64):
    flops = 6 * B * H * T * T * D
    nbytes = 4 * B * T * H * D * 2 + H * (2 * T - 1) * D * 2 + 2 * H * D * 4
    return 1e3 * max(flops / 989e12, nbytes / 3.35e12)


def library(q, k, v, p, u, w, lengths):
    """SDPA with the rel-shifted position term as a float mask: (B, T, H, D) bf16."""
    B, T, H, D = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    bd = torch.matmul(qh + w.to(q.dtype)[None, :, None], p.permute(1, 2, 0))  # (B, H, T, 2T-1)
    bd = torch.cat([bd.new_zeros((B, H, T, 1)), bd], dim=-1).view(B, H, 2 * T, T)
    bd = bd[:, :, 1:].reshape(B, H, T, 2 * T - 1)[:, :, :, :T]
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    shift = ((valid.to(q.dtype) - 1.0) * 1e9)[:, None, None, :]
    mask = bd * (1.0 / math.sqrt(D)) + shift
    out = F.scaled_dot_product_attention(qh + u.to(q.dtype)[None, :, None], kh, vh,
                                         attn_mask=mask)
    return out.transpose(1, 2)


def peak_bytes(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    D = 64
    if args[:1] == ["--d"]:
        D, args = int(args[1]), args[2:]
    args = [int(a) for a in args]
    B = args[0] if args else 32
    lengths_t = args[1:] or [801, 1601]
    if not torch.cuda.is_available():
        raise SystemExit("ab_relpos.py times the card and needs a CUDA device")
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    for T in lengths_t:
        g = torch.Generator().manual_seed(T)
        q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev, torch.bfloat16)
                   for _ in range(3))
        p = torch.randn(2 * T - 1, H, D, generator=g).to(dev, torch.bfloat16)
        u, w = ((0.125 * torch.randn(H, D, generator=g)).to(dev) for _ in range(2))
        lengths = torch.from_numpy(np.random.default_rng(T).integers(
            3 * T // 4, T + 1, B).astype(np.int32)).to(dev)
        args_ = (q, k, v, p, u, w, lengths)
        with torch.no_grad():
            want = torch.cat([relpos_attention_ref(q[i:i + 4], k[i:i + 4], v[i:i + 4], p, u, w,
                                                   lengths[i:i + 4]) for i in range(0, B, 4)])
            row = {"B": B, "H": H, "T": T, "D": D,
                   "kernel_ms": device_ms(lambda: relpos_attention(*args_)),
                   "plain_ms": device_ms(lambda: relpos_attention_ref(*args_), calls=3),
                   "library_ms": device_ms(lambda: library(*args_)),
                   "bound_ms": bound_ms(B, T, D),
                   "kernel_err": (relpos_attention(*args_).float() - want.float()).abs().max().item(),
                   "library_err": (library(*args_).float() - want.float()).abs().max().item(),
                   "kernel_peak_bytes": peak_bytes(lambda: relpos_attention(*args_)),
                   "library_peak_bytes": peak_bytes(lambda: library(*args_)),
                   "plain_peak_bytes": peak_bytes(lambda: relpos_attention_ref(*args_))}
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        del q, k, v, p, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
