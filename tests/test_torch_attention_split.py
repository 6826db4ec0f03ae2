"""Why the attention backward kernel splits its fp32 operands.

``csrc/flash_attention_bwd.cu`` runs its five products on the bf16 tensor
cores (wgmma), while ``_bwd_tile`` (turkish_asr_tpu/ops/_flash_attention_impl.py
:317-374) and the plain version take every product on fp32 operands (g, ds
and y are fp32). The kernel carries g, ds and y, and fp32 q, k, v, as bf16
parts (``csrc/flash_wgmma.cuh``): pairs x = hi + lo, two terms against a
bf16 operand (hi*b + lo*b), three against another pair (hi*hi + hi*lo +
lo*hi); g (and fp32 v) in three parts for dp = g v^T; ds goes to the dq
product as the same pair. This models that
arithmetic on the CPU: every operand rounded to bf16 values first, each
partial product exact, the sums fp32, the forward's m, l and delta from the
same model. The split holds dq, dk, dv within 1e-4 of the largest gradient
of ``flash_attention_bwd_ref`` (the card check's tolerance); rounding g
and ds once to bf16 does not, nor g and fp32 v as pairs in dp where a row
sits on one key.
"""

import math

import numpy as np
import pytest
import torch

from turkish_asr_torch.ops._flash_attention import flash_attention_bwd_ref

B, H, KH, T, D = 2, 4, 1, 37, 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _parts(x, n):
    """x as n bf16 terms: each rounds what the terms before it left."""
    out = []
    for _ in range(n):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _matmul(a, b, na, nb):
    """a @ b from na and nb bf16 terms, each partial product exact in fp32,
    over the pairs of terms (i, j) with i + j < max(na, nb), as the kernel's
    products_ss and products_rs: two pairs give hi*hi + hi*lo + lo*hi."""
    pa, pb = _parts(a, na), _parts(b, nb)
    top = max(na, nb) - 1
    return sum(torch.matmul(pa[i], pb[j]) for i in range(na) for j in range(nb) if i + j <= top)


def _inputs(dtype, B=B, T=T, lengths=(T, 20), seed=4):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, T, D), np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, KH, T, D), np.float32)).to(dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((B, H, T, D), np.float32))
    mask = torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, mask, g


def _kernel_model(q, k, v, mask, g, split=True, g_parts=3):
    """The forward's m, l and delta = rowsum(g * out), and dq, dk, dv as the
    backward kernel forms them (dropout off), from the kernel's own parts:
    q, k, v one bf16 term (bf16 data) or a pair (fp32); g in g_parts terms
    (and fp32 v as many) in dp = g v^T; ds and y in pairs, g in a pair for
    dv = y^T g. split=False rounds g, ds and y once to bf16 instead."""
    n_in = 2 if q.dtype == torch.float32 else 1
    Bq, _, Tq, _ = q.shape
    scale = 1.0 / math.sqrt(D)
    rows = (Bq, 1, H * Tq)
    qf, gf = q.float().reshape(*rows, D), g.reshape(*rows, D)
    kf, vf = k.float(), v.float()
    s = (_matmul(qf, kf.transpose(-1, -2), n_in, n_in) * scale
         + (mask.float()[:, None, None, :] - 1.0) * 1e9)
    m = s.amax(-1, keepdim=True)
    l = torch.exp(s - m).sum(-1, keepdim=True)
    p = torch.exp(s - m) / l
    out = _matmul(p if n_in == 2 else _bf16(p), vf, n_in, n_in)
    delta = (gf * out).sum(-1, keepdim=True)
    n_g, n_pair = (g_parts, 2) if split else (1, 1)
    dp = _matmul(gf, vf.transpose(-1, -2), n_g, n_g if n_in == 2 else 1)
    ds = p * (dp - delta) * scale
    dq = _matmul(ds, kf, n_pair, n_in)
    dk = _matmul(ds.transpose(-1, -2), qf, n_pair, n_in)
    dv = _matmul(p.transpose(-1, -2), gf, n_pair, n_pair)
    stats = tuple(x.reshape(Bq, H, Tq) for x in (m, l, delta))
    return stats, (dq.reshape(Bq, H, Tq, D), dk, dv)


def _worst(q, k, v, mask, g, **model):
    """Largest |kernel model - plain version| over max(1, the largest plain
    element), across dq, dk, dv: chip_smoke.py's measure."""
    (m, l, delta), got = _kernel_model(q, k, v, mask, g, **model)
    want = flash_attention_bwd_ref(q, k, v, mask, m, l, delta, g)
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16-qkv-2-and-3-term", "fp32-qkv-3-term"])
def test_hi_lo_split_holds_the_card_tolerance(dtype):
    """bf16 q, k, v: ds against k and q take 2 terms, y against g 3, g
    against v 3; fp32 q, k, v: the pairs take 3 terms, g against v 6."""
    assert _worst(*_inputs(dtype)) < 1e-4


def test_one_bf16_rounding_of_g_and_ds_breaks_it():
    assert _worst(*_inputs(torch.bfloat16), split=False) > 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_takes_g_in_three_parts(seed):
    """A row whose only valid key is key 0 puts p = 1 there, so ds = p (dp -
    delta) is all cancellation, and 4*T' rows of it add up in dk. With g and
    fp32 v as pairs the kernel model breaks 1e-4 of the largest gradient
    there (B=4, T'=201, one row of length 1, as chip_smoke's attention
    phase has it); with three parts it holds, for fp32 and bf16 q, k, v."""
    case = dict(B=4, T=201, lengths=(201, 134, 0, 1), seed=seed)
    assert _worst(*_inputs(torch.float32, **case), g_parts=2) > 1e-4
    for dtype in (torch.float32, torch.bfloat16):
        assert _worst(*_inputs(dtype, **case), g_parts=3) < 3e-5


def test_split_is_exact_to_two_to_the_minus_17():
    """|x - hi - lo| <= 2^-17 |x| and a third part <= 2^-25 |x| for normal
    fp32 x (each part rounds the remainder to 8 significant bits)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo, lo2 = _parts(x, 3)
    assert ((x - hi - lo).abs() <= 2.0 ** -17 * x.abs()).all()
    assert ((x - hi - lo - lo2).abs() <= 2.0 ** -25 * x.abs()).all()
    assert ((x - hi).abs() > 2.0 ** -12 * x.abs()).any()  # one rounding alone is coarse
