"""Tests of the port's CUDA kernels on the card.

They skip without a CUDA device. This file imports no jax (the card's
machine has none), so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states them: fp32 inputs 1e-4 absolute on
out and lse; bf16 inputs 2e-2 on out (both sides round the normalized p
to bf16, with row sums in another order) and 1e-3 on lse. The backward
kernels rebuild the forward's p bit for bit and carry the fp32 operands
(g, ds, y, and q, k, v in fp32) through the bf16 tensor cores as hi + lo
pairs, so dq, dk, dv agree within 1e-4 of the largest gradient for both
input dtypes; the dk/dv partial sums are added in a fixed order and dq
is one block's sum, so two calls agree bit for bit. The CTC kernels run the plain
version's fp32 recursion with the card's own exp/log1p: losses within
1e-5 relative, gradients within 1e-5 absolute (lane sums in another
order) on the small cases, and chip_smoke.py's tolerances (nll 1e-5
relative + 1e-4, gradients 1e-4 of 1 + |plain|) at the path edges, where
impossible rows sum unscaled lane values to hundreds; two backward calls
agree bit for bit. The dump kernel is bit-identical to the plain hash and
launches one device kernel a call. The SwiGLU kernel is held within 2^-7
max|plain| of the fused plain version (exact bf16 products summed in fp32
in other orders, so g can round one bf16 ulp apart), and two calls agree
bit for bit.
"""

import contextlib
import io
import json
import re
from unittest import mock

import numpy as np
import pytest
import torch

from turkish_asr_torch.models import attention
from turkish_asr_torch.models.attention import MultiQueryAttention
from turkish_asr_torch.ops import ctc as ctc_ops
from turkish_asr_torch.ops import flash_attention as fa_ops
from turkish_asr_torch.ops import swiglu as sw
from turkish_asr_torch.ops._ctc import ctc_bwd_ref, ctc_fwd_ref, ctc_topology
from turkish_asr_torch.ops._dropout import keep_mask_ref, keep_rows_ref
from turkish_asr_torch.ops._flash_attention import (
    flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_fwd_stats_ref)
from turkish_asr_torch.ops.ctc import ctc_loss
from turkish_asr_torch.ops._swiglu import swiglu_fused_ref
from turkish_asr_torch.ops.flash_attention import _check, dump_keep_mask, flash_attention
from turkish_asr_torch.scripts import ab_swiglu
from turkish_asr_torch.utils import tracing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _launches(name):
    """A kernel wrapper's launch counter (``utils/tracing.py``)."""
    return tracing.counters()[name]


def _inputs(B, H, Kh, T, D, lengths, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, T, D, generator=g).to(device, dtype)
    k = torch.randn(B, Kh, T, D, generator=g).to(device, dtype)
    v = torch.randn(B, Kh, T, D, generator=g).to(device, dtype)
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]).to(device)
    return q, k, v, mask


def _lengths(B, T):
    """A full row, a half row, an empty row, then seeded lengths in [1, T]."""
    rest = np.random.default_rng(B * 1000 + T).integers(1, T + 1, max(0, B - 3)).tolist()
    return ([T, T // 2, 0] + rest)[:B]


# (B, Kh, T, D): ragged small shapes, D = 40 and 128, and the main path's
# two shapes, training (B=32, T'=200) and the long served bucket (B=16 x
# 24 s, T'=601), both MQA at D=64.
ATTENTION_SHAPES = [(3, 1, 201, 64), (3, 4, 37, 64), (3, 1, 70, 128), (3, 2, 9, 40),
                    (32, 1, 200, 64), (16, 1, 601, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Kh,T,D", ATTENTION_SHAPES)
def test_kernel_matches_plain_version(cuda, dtype, atol, B, Kh, T, D, rate):
    H = 4 if Kh != 2 else 2
    q, k, v, mask = _inputs(B, H, Kh, T, D, _lengths(B, T), dtype, cuda)
    before = _launches("flash_attention_fwd")
    out, lse = flash_attention(q, k, v, mask, rate, 7)
    want_out, want_lse = flash_attention_fwd_ref(q, k, v, mask, rate, 7)
    torch.cuda.synchronize()
    assert _launches("flash_attention_fwd") == before + 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, rtol=0, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_kernel_without_mask_and_with_uint8_mask(cuda):
    q, k, v, mask = _inputs(2, 4, 1, 50, 64, [50, 20], torch.float32, cuda)
    out, _ = flash_attention(q, k, v, None)
    torch.testing.assert_close(out, flash_attention_fwd_ref(q, k, v, None)[0],
                               rtol=0, atol=1e-4)
    a, _ = flash_attention(q, k, v, mask)
    b, _ = flash_attention(q, k, v, mask.to(torch.uint8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _inputs(1, 4, 1, 16, 64, [16], torch.float16, cuda)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        flash_attention(q, k, v, mask)


@pytest.mark.parametrize("change,match", [
    (lambda q, k, v, m: (q.to(torch.float16), k.to(torch.float16), v.to(torch.float16), m),
     "bf16 or fp32"),
    (lambda q, k, v, m: (q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous(), m), "multiple of 8"),
    (lambda q, k, v, m: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, m),
     "contiguous"),
    (lambda q, k, v, m: (q, k, v, m[:, :5]), "mask must be"),
    (lambda q, k, v, m: (q, k.expand(1, 2, 16, 64).contiguous(),
                         v.expand(1, 2, 16, 64).contiguous(), m), "heads must be"),
    (lambda q, k, v, m: (q, k[:, :, :8], v[:, :, :8], m), "does not match"),
])
def test_wrapper_checks_inputs(change, match):
    """The checks the wrapper makes before a launch (pure shape/dtype
    logic, so they run on CPU tensors)."""
    q, k, v, mask = _inputs(1, 4, 1, 16, 64, [16], torch.float32, "cpu")
    with pytest.raises(ValueError, match=match):
        _check(*change(q, k, v, mask))
    _check(q, k, v, mask)


@pytest.mark.cuda
def test_attention_gradients_reach_q_k_v_on_the_card(cuda):
    """Every projection of the attention module gets the plain version's
    gradient on the card. Before the kernel had an autograd Function, its
    output carried no graph, so linear_q/k/v got no gradient at all."""
    torch.manual_seed(0)
    weights = MultiQueryAttention(64, 4).state_dict()
    grads = []
    for plain in (False, True):
        mod = MultiQueryAttention(64, 4)
        mod.load_state_dict(weights)
        mod.to(cuda)
        x = torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
        mask = (torch.arange(37)[None, :] < torch.tensor([37, 20])[:, None]).to(cuda)
        fn = ((lambda q, k, v, m, r, s: flash_attention_fwd_ref(q, k, v, m, r, s))
              if plain else attention.flash_attention)
        with mock.patch.object(attention, "flash_attention", fn):
            mod(x, mask, torch.float32, dropout=0.1, seed=3).square().sum().backward()
        grads.append({n: p.grad for n, p in mod.named_parameters()})
    for name, g in grads[1].items():
        got = grads[0][name]
        assert got is not None and got.abs().max() > 0, name
        torch.testing.assert_close(got, g, rtol=1e-4, atol=1e-4 * g.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Kh,T,D", ATTENTION_SHAPES)
def test_backward_kernel_matches_plain_version(cuda, dtype, B, Kh, T, D, rate):
    H = 4 if Kh != 2 else 2
    q, k, v, mask = _inputs(B, H, Kh, T, D, _lengths(B, T), dtype, cuda)
    g = torch.randn(B, H, T, D, generator=torch.Generator().manual_seed(5)).to(cuda)
    out, lse, m, l = fa_ops._fwd(q, k, v, mask, rate, 11)
    want = flash_attention_fwd_stats_ref(q, k, v, mask, rate, 11)
    torch.testing.assert_close(out, want[0], rtol=0, atol=1e-4 if dtype == torch.float32 else 2e-2)
    delta = (g * out).sum(-1)
    before = _launches("flash_attention_bwd")
    got = fa_ops._bwd(q, k, v, mask, m, l, delta, g, rate, 11)
    ref = flash_attention_bwd_ref(q, k, v, mask, m, l, delta, g, rate, 11)
    torch.cuda.synchronize()
    assert _launches("flash_attention_bwd") == before + 1
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, b.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Kh,T,rate", [(4, 1, 801, 0.0), (4, 4, 801, 0.0), (32, 1, 200, 0.1)])
def test_backward_kernel_is_deterministic(cuda, B, Kh, T, rate):
    """Two backward calls on the same inputs give the same bits: the dk/dv
    chunks are summed in a fixed order and dq is one block's sum over the
    key tiles, with no atomics (MQA at B=4, T'=801 takes four chunks, at
    B=32, T'=200 two)."""
    q, k, v, mask = _inputs(B, 4, Kh, T, 64, _lengths(B, T), torch.bfloat16, cuda)
    g = torch.randn(B, 4, T, 64, generator=torch.Generator().manual_seed(5)).to(cuda)
    _, _, m, l = fa_ops._fwd(q, k, v, mask, rate, 3)
    delta = torch.randn(B, 4, T, generator=torch.Generator().manual_seed(6)).to(cuda)
    first = fa_ops._bwd(q, k, v, mask, m, l, delta, g, rate, 3)
    second = fa_ops._bwd(q, k, v, mask, m, l, delta, g, rate, 3)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_attention_op_is_the_kernel_or_its_plain_version(device, request):
    """``torch.ops.turkish_asr_torch.flash_attention_fwd``: on CPU tensors the
    plain version itself; on the card one kernel launch, held to the plain
    version as test_kernel_matches_plain_version holds it (fp32 1e-4)."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    q, k, v, mask = _inputs(3, 4, 1, 201, 64, _lengths(3, 201), torch.float32, device)
    before = _launches("flash_attention_fwd")
    got = torch.ops.turkish_asr_torch.flash_attention_fwd(q, k, v, mask, 0.1, 5)
    want = flash_attention_fwd_stats_ref(q, k, v, mask, 0.1, 5)
    if device == "cuda":
        torch.cuda.synchronize()
    assert _launches("flash_attention_fwd") == before + (device == "cuda")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 if device == "cuda" else 0)


@pytest.mark.cuda
def test_exported_program_launches_the_kernel(cuda, tmp_path):
    """A ``torch.export`` program of the model (export_model.export_program)
    launches the forward kernel once a block a forward (export_launches in
    chip_smoke.py's kernels line) and matches the eager model in fp32."""
    from turkish_asr_torch.export_model import export_program
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    cfg = ModelConfig(n_mels=80, d_model=64, n_heads=2, n_blocks=3, n_classes=56, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0)).to(cuda).eval()
    path = str(tmp_path / "m.pt2")
    export_program(model, cfg, path, cuda)
    program = torch.export.load(path).module()
    x = torch.randn(5, 124, 80, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = _launches("flash_attention_fwd")
    with torch.no_grad():
        got = program(x)
        torch.cuda.synchronize()
        launches = _launches("flash_attention_fwd") - before
        want = model(x, None, torch.float32)
    assert launches == cfg.n_blocks
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("slots", [132, 264, 528])
@pytest.mark.parametrize("B,H,Kh,T", [(4, 4, 1, 801), (4, 4, 4, 801), (32, 4, 1, 200),
                                      (16, 4, 1, 601), (3, 2, 2, 9), (1, 4, 1, 1)])
def test_dkdv_chunks_cover_the_rows(B, H, Kh, T, slots):
    """The dk/dv split of ``attention_plan`` (pure shape logic, runs
    without a card): chunks of a whole number of 64-row tiles, none empty,
    covering every row, for both dtypes' blocks."""
    rows = H * T if Kh == 1 else T
    for fp32 in (False, True):
        plan = fa_ops.attention_plan(B, H, Kh, T, 64, fp32, slots)
        assert plan.chunk_rows % 64 == 0 and plan.chunks >= 1
        assert (plan.chunks - 1) * plan.chunk_rows < rows <= plan.chunks * plan.chunk_rows
        assert plan.dkdv_grid == (-(-T // plan.block_rows), plan.chunks, B * Kh)


def _chunks(*shape):
    plan = fa_ops.attention_plan(*shape)
    return plan.chunks, plan.chunk_rows


def test_dkdv_chunks_at_the_main_path_shapes():
    """At 132 slots (the H100's 132 SMs x the one block an SM of the bf16
    D=64 dk/dv instance, test_dkdv_occupancy_of_the_main_path_instance;
    128 keys a block): training (B=32, T'=200, MQA) takes two chunks of 7
    row tiles, one wave of 128 blocks; B=4, T'=801: four MQA chunks of 13
    (112 blocks), and MHA none (112); config 5's B=4, T'=1601: five
    chunks of 41 (260 blocks, two waves)."""
    assert _chunks(32, 4, 1, 200, 64, False, 132) == (2, 7 * 64)
    assert _chunks(4, 4, 1, 801, 64, False, 132) == (4, 13 * 64)
    assert _chunks(4, 4, 4, 801, 64, False, 132) == (1, 13 * 64)
    assert _chunks(4, 8, 1, 1601, 64, False, 132) == (5, 41 * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0, 1])
def test_dkdv_occupancy_of_the_main_path_instance(cuda, dropout):
    """The bf16 D=64 dk/dv instance takes one block an SM (two consumer
    warpgroups and a producer, 168 registers a thread at launch): the
    slots the main-path splits above assume. The fp32 D=128 instance (one
    consumer warpgroup) takes one or two."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa_ops._dkdv_slots(cuda.index or 0, 64, 1, dropout) == sms
    assert 1 <= fa_ops._dkdv_slots(cuda.index or 0, 128, 0, dropout) <= 2 * sms


@pytest.mark.cuda
@pytest.mark.parametrize("H,T", [(4, 201), (2, 9)])
def test_dump_kernel_is_the_plain_hash(cuda, H, T):
    before = _launches("dropout_mask")
    got = dump_keep_mask(3, H, T, 0xC0FFEE, 0.1, cuda)
    torch.cuda.synchronize()
    assert _launches("dropout_mask") == before + 1
    assert torch.equal(got, keep_mask_ref(0xC0FFEE, 3, H, T, 0.1, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17])
def test_dump_kernel_across_its_16_byte_groups(cuda, T):
    """B*H odd and T' around 16: rows start at every phase of the kernel's
    16-byte groups, and the element count is no multiple of 16."""
    got = dump_keep_mask(3, 3, T, 0xBEEF + T, 0.3, cuda)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool
    assert torch.equal(got, keep_mask_ref(0xBEEF + T, 3, 3, T, 0.3, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [46341, 65537])
def test_dump_kernel_past_2_to_the_31_and_32_elements(cuda, T):
    """One (1, 1, T', T') dump of 2.1 GB (32-bit indices past 2^31) and of
    4.3 GB (the 64-bit instance): the rows around the boundaries and the
    last rows against the plain hash of those rows alone."""
    keep = dump_keep_mask(1, 1, T, 0xC0FFEE, 0.1, cuda)
    rows = sorted({0, (2 ** 31) // T, (2 ** 32) // T, T - 2, T - 1} & set(range(T)))
    try:
        assert torch.equal(keep[0, 0, rows], keep_rows_ref(0xC0FFEE, 0, 1, 0, rows, T, 0.1, cuda))
    finally:
        del keep
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_dump_launches_one_device_kernel(cuda):
    """The kernel writes the bool buffer itself: no cast kernel after it."""
    from turkish_asr_torch.scripts.ab_attention import device_kernels
    kernels = device_kernels(lambda: dump_keep_mask(4, 4, 801, 7, 0.1, cuda))
    assert all("dump_keep_mask_kernel" in name for name in kernels), kernels
    assert round(sum(kernels.values())) == 1


def _ctc_case(B, T, V, L, cuda, seed=0):
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g), -1)
    tg = torch.randint(1, V, (B, L), generator=g)
    tg[0, 1::2] = tg[0, 0::2][: tg[0, 1::2].numel()]  # repeats
    il = torch.randint(T // 2, T + 1, (B,), generator=g)
    tl = torch.randint(1, L + 1, (B,), generator=g)
    il[-1], tl[-1] = 1, 0  # collate's dummy row
    return [x.to(cuda) for x in (lp, tg, il, tl)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(4, 50, 7, 9), (3, 60, 1000, 700), (5, 40, 32768, 12),
                                     (2, 6, 5, 8)])
def test_ctc_kernels_match_plain_version(cuda, B, T, V, L):
    """Ragged lengths, repeated labels, a dummy row, S = 1401 lanes (more
    than a block's threads), V = 32768, and an impossible alignment (T=6)."""
    lp, tg, il, tl = _ctc_case(B, T, V, L, cuda)
    ext, skip = ctc_topology(tg, 0)
    before = (_launches("ctc_fwd"), _launches("ctc_bwd"))
    nll, alpha = ctc_ops._forward(lp, tg, il, tl, 0)
    want_nll, want_alpha = ctc_fwd_ref(lp, ext, skip, il, tl)
    torch.testing.assert_close(nll, want_nll, rtol=1e-5, atol=1e-5)
    cot = torch.rand(B, generator=torch.Generator().manual_seed(2)).to(cuda)
    grad = ctc_ops._backward(lp, tg, il, tl, alpha, nll, cot, 0)
    want = ctc_bwd_ref(lp, ext, skip, il, tl, want_alpha, want_nll, cot)
    torch.cuda.synchronize()
    assert (_launches("ctc_fwd"), _launches("ctc_bwd")) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(grad).all()
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-5)


def _ctc_against_plain(lp, tg, il, tl, cot):
    """The kernels' nll, alpha and gradient against the plain versions:
    nll 1e-5 relative + 1e-4, alpha rows t < input_length 1e-5 relative +
    1e-4, the gradient 1e-4 of 1 + |plain| (chip_smoke.py's tolerances).
    Returns the kernels' (nll, alpha, grad)."""
    ext, skip = ctc_topology(tg, 0)
    nll, alpha = ctc_ops._forward(lp, tg, il, tl, 0)
    grad = ctc_ops._backward(lp, tg, il, tl, alpha, nll, cot, 0)
    want_nll, want_alpha = ctc_fwd_ref(lp, ext, skip, il, tl)
    want = ctc_bwd_ref(lp, ext, skip, il, tl, want_alpha, want_nll, cot)
    torch.cuda.synchronize()
    assert torch.isfinite(nll).all() and torch.isfinite(grad).all()
    assert ((nll - want_nll).abs() <= 1e-5 * want_nll.abs() + 1e-4).all()
    written = torch.arange(lp.shape[1], device=lp.device)[None, :] < il[:, None]
    a, w = alpha[written], want_alpha[written]
    assert ((a - w).abs() <= 1e-5 * w.abs() + 1e-4).all()
    assert ((grad - want).abs() <= 1e-4 * (1 + want.abs())).all()
    return nll, alpha, grad


# (T', L): S = 1055 and 1057 on either side of the warp path's 32 x 33
# lanes, T' = 77 across 32-frame chunks, and S = 8191 (the wide path's 16
# warps; its forward stages 2 frames a chunk, its backward 1).
@pytest.mark.cuda
@pytest.mark.parametrize("T,L", [(120, 527), (120, 528), (77, 64), (33, 9), (30, 4095)])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_ctc_kernels_at_the_path_edges(cuda, T, L, index_dtype):
    lp, tg, il, tl = _ctc_case(4, T, 56, L, cuda, seed=L)
    il[0], tl[0] = T, min(L, T // 2)  # a feasible full-length row
    tg, il, tl = (x.to(index_dtype) for x in (tg, il, tl))
    cot = torch.rand(4, generator=torch.Generator().manual_seed(1)).to(cuda)
    _ctc_against_plain(lp, tg, il, tl, cot)


@pytest.mark.cuda
def test_ctc_kernels_at_input_lengths_zero_and_one(cuda):
    """Rows of 0 and 1 frames (with and without a target) and one longer
    than T': no alpha row is written for a 0-frame row, every gradient row
    past a row's length is 0."""
    lp, tg, il, tl = _ctc_case(5, 40, 30, 6, cuda, seed=4)
    il.copy_(torch.tensor([0, 1, 1, 0, 45]))
    tl.copy_(torch.tensor([0, 0, 1, 2, 3]))
    cot = torch.ones(5, device=cuda)
    _, _, grad = _ctc_against_plain(lp, tg, il, tl, cot)
    assert (grad[0] == 0).all() and (grad[3] == 0).all() and (grad[1:3, 1:] == 0).all()


@pytest.mark.cuda
def test_ctc_kernels_with_one_label_repeated(cuda):
    """A target of one label L times: the longest chain of equal-label
    lanes, and no skip transition anywhere."""
    B, T, L = 3, 300, 100
    lp, tg, il, tl = _ctc_case(B, T, 20, L, cuda, seed=6)
    tg.fill_(7)
    il.fill_(T)
    tl.copy_(torch.tensor([L, L // 2, 1]))
    _ctc_against_plain(lp, tg, il, tl, torch.rand(B, device=cuda))


@pytest.mark.cuda
def test_ctc_kernels_on_an_all_impossible_batch(cuda):
    """Every row has more labels than it has frames for: losses at the
    sentinel's scale (zero_infinity makes them 0), gradients finite."""
    lp, tg, il, tl = _ctc_case(4, 20, 30, 40, cuda, seed=8)
    il.fill_(10)
    tl.fill_(30)
    nll, _, _ = _ctc_against_plain(lp, tg, il, tl, torch.rand(4, device=cuda))
    assert (nll > 1e29).all()
    assert (ctc_loss(lp, tg, il, tl, reduction="none") == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(32, 200, 56, 64), (3, 60, 1000, 700)])
def test_ctc_backward_is_deterministic(cuda, B, T, V, L):
    """Two backward calls give the same bits: the labels' lanes are summed
    in a fixed order, with no atomics."""
    lp, tg, il, tl = _ctc_case(B, T, V, L, cuda, seed=9)
    cot = torch.rand(B, generator=torch.Generator().manual_seed(3)).to(cuda)
    nll, alpha = ctc_ops._forward(lp, tg, il, tl, 0)
    first = ctc_ops._backward(lp, tg, il, tl, alpha, nll, cot, 0)
    second = ctc_ops._backward(lp, tg, il, tl, alpha, nll, cot, 0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(32, 200, 56, 64), (4, 77, 1000, 12)])
def test_ctc_gradient_writes_every_element(cuda, B, T, V, L):
    """The gradient comes from torch.empty: handed the block the allocator
    last held as NaN, every element comes back finite and equal to the
    plain version's, zeros included."""
    lp, tg, il, tl = _ctc_case(B, T, V, L, cuda, seed=10)
    cot = torch.rand(B, generator=torch.Generator().manual_seed(4)).to(cuda)
    nll, alpha = ctc_ops._forward(lp, tg, il, tl, 0)
    torch.cuda.synchronize()
    poison = torch.full((B, T, V), float("nan"), device=cuda)
    del poison
    grad = ctc_ops._backward(lp, tg, il, tl, alpha, nll, cot, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(grad).all()
    ext, skip = ctc_topology(tg, 0)
    want = ctc_bwd_ref(lp, ext, skip, il, tl, *reversed(ctc_fwd_ref(lp, ext, skip, il, tl)), cot)
    assert ((grad - want).abs() <= 1e-4 * (1 + want.abs())).all()
    labels = torch.zeros(B, V, dtype=torch.bool, device=cuda)
    labels[:, 0] = True
    labels.scatter_(1, tg.long(), True)
    assert (grad.masked_fill(labels[:, None, :], 0) == 0).all()  # no label: exactly 0


@pytest.mark.cuda
def test_ctc_loss_launches_no_topology_kernels(cuda):
    """On the card one ctc_loss forward launches the forward kernel and the
    reduction, and its backward the gradient kernel: no topology, chain,
    cast or fill kernels (int32 targets and lengths, as the trainer gives
    them). The profiler's fullest of five windows: on the card it now and
    then drops a window's events."""
    from turkish_asr_torch.scripts.ab_attention import device_kernels
    lp, tg, il, tl = _ctc_case(8, 50, 30, 9, cuda, seed=11)
    tg, il, tl = (x.to(torch.int32) for x in (tg, il, tl))
    x = lp.clone().requires_grad_(True)

    def step():
        nll = ctc_ops.CTCNegLogLikelihood.apply(x, tg, il, tl, 0)
        torch.autograd.grad(nll, x, torch.ones_like(nll))

    names = list(device_kernels(step, calls=1))
    assert any("ctc_fwd_kernel" in n for n in names) and any("ctc_bwd_kernel" in n for n in names)
    others = [n for n in names if "ctc_fwd_kernel" not in n and "ctc_bwd_kernel" not in n]
    assert len(others) <= 1, others  # at most the ones_like fill of the cotangent


@pytest.mark.cuda
def test_ctc_kernels_log1p_is_log1pf_bit_for_bit(cuda):
    """The kernels' branch-free log1p against the math library's log1pf
    over every float in [0, 1] (the range exp(-|a - b|) takes) and every
    NaN: no bit differs."""
    assert ctc_ops.log1p_unit_mismatches(cuda) == 0


@pytest.mark.cuda
def test_ctc_loss_gradient_on_the_card(cuda):
    """The autograd Function end to end: the card's loss and logit gradient
    against the CPU's."""
    lp, tg, il, tl = _ctc_case(4, 50, 30, 9, "cpu", seed=3)
    got = []
    for dev in (cuda, "cpu"):
        x = lp.clone().to(dev).requires_grad_(True)
        loss = ctc_loss(x, tg.to(dev), il.to(dev), tl.to(dev))
        loss.backward()
        got.append((loss.item(), x.grad.cpu()))
    assert abs(got[0][0] - got[1][0]) <= 1e-5 * abs(got[1][0])
    torch.testing.assert_close(got[0][1], got[1][1], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [6400, 6401, 25600, 5, 3000])
def test_swiglu_kernel_matches_plain_version(cuda, M):
    """Every row tile, the A/B's inputs with nonzero biases, the output in
    a block the allocator last held as NaN (an unwritten row shows). At
    tm=128 on the H100 (132 SMs) the plan splits F over clusters of 2 at
    M=6400 and 6401, of 8 at M=5 and of 4 at M=3000 (24 tiles)."""
    rng = np.random.default_rng(M)
    x, w1, _, w2, _ = ab_swiglu.make_inputs(M, 256, 1024)
    b1 = (0.1 * rng.standard_normal((1, 2048))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, 256))).astype(np.float32)
    args = sw.args_from_numpy(x, w1, b1, w2, b2, cuda)
    want = swiglu_fused_ref(*args).float()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_cluster = {6400: 2, 6401: 2, 25600: 1, 5: 8, 3000: 4}[M]
    assert sw.swiglu_plan(M, 256, 1024, 128, sms).cluster == want_cluster
    for tm in sw.ROW_TILES:
        poison = torch.full((M, 256), float("nan"), dtype=torch.bfloat16, device=cuda)
        del poison
        before = _launches("swiglu_fwd")
        got = sw.swiglu(*args, tm=tm)
        torch.cuda.synchronize()
        assert _launches("swiglu_fwd") == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (M, 256)
        assert torch.isfinite(got.float()).all(dim=1).all()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=2.0 ** -7 * want.abs().max().item())


@pytest.mark.cuda
def test_swiglu_kernel_takes_narrow_and_ragged_shapes(cuda):
    """C and F that are no multiple of the kernel's 64-column atoms and
    64- or 128-unit chunks."""
    rng = np.random.default_rng(0)
    x, w1, b1, w2, b2 = (rng.standard_normal(s).astype(np.float32) * 0.3
                         for s in ((37, 40), (40, 2 * 70), (1, 140), (70, 40), (1, 40)))
    args = sw.args_from_numpy(x, w1, b1, w2, b2, cuda)
    want = swiglu_fused_ref(*args).float()
    for tm in sw.ROW_TILES:
        got = sw.swiglu(*args, tm=tm).float()
        torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -7 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,F", [(6400, 256, 1024), (6401, 256, 1024), (6400, 256, 1000),
                                   (37, 40, 70)])
def test_swiglu_kernel_is_deterministic(cuda, M, C, F):
    """Two calls give the same bits at every tile: the cluster's partial
    y's are summed in a fixed order."""
    rng = np.random.default_rng(M + F)
    args = sw.args_from_numpy(*(rng.standard_normal(shape).astype(np.float32) * 0.1
                                for shape in ((M, C), (C, 2 * F), (1, 2 * F), (F, C), (1, C))),
                              cuda)
    for tm in sw.ROW_TILES:
        first, second = sw.swiglu(*args, tm=tm), sw.swiglu(*args, tm=tm)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("C,F", [(256, 1000), (256, 1020), (200, 64), (136, 96)])
def test_swiglu_kernel_at_its_copy_paths_edges(cuda, C, F):
    """F off the 64-unit chunk through TMA (1000), F % 8 == 4 (the copy
    path at width), C = 200 and 136 (off the 64-column atom), against the
    fused plain version at every tile."""
    rng = np.random.default_rng(C + F)
    M = 6400
    args = sw.args_from_numpy(*(rng.standard_normal(shape).astype(np.float32) * scale
                                for shape, scale in (((M, C), 1.0), ((C, 2 * F), 0.05),
                                                     ((1, 2 * F), 0.1), ((F, C), 0.05),
                                                     ((1, C), 0.1))), cuda)
    want = swiglu_fused_ref(*args).float()
    for tm in sw.ROW_TILES:
        got = sw.swiglu(*args, tm=tm).float()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -7 * want.abs().max().item())


@pytest.mark.cuda
def test_swiglu_launches_one_device_kernel(cuda):
    from turkish_asr_torch.scripts.ab_attention import device_kernels
    x, w1, b1, w2, b2 = ab_swiglu.make_inputs(6400, 256, 1024)
    args = sw.args_from_numpy(x, w1, b1, w2, b2, cuda)
    kernels = device_kernels(lambda: sw.swiglu(*args))
    assert all("swiglu_fwd_kernel" in name for name in kernels), kernels
    assert round(sum(kernels.values())) == 1


@pytest.mark.cuda
def test_swiglu_ab_script_prints_its_lines(cuda):
    out = io.StringIO()
    before = _launches("swiglu_fwd")
    with contextlib.redirect_stdout(out):
        result = ab_swiglu.main(["640", "256", "1024"])
    lines = out.getvalue().splitlines()
    assert len(lines) == len(sw.ROW_TILES) + 5
    assert lines[0].startswith(torch.cuda.get_device_name(0) + "; checkout ")
    times = r"device [0-9.]+ ms, chained [0-9.]+ ms"
    err = r"\(max err vs chain [0-9.e+-]+\)"
    for i, tm in enumerate(sw.ROW_TILES):
        assert re.fullmatch(rf"cuda tm= *{tm}: {times} {err}", lines[1 + i])
    assert re.fullmatch(rf"fused plain: {times} {err}", lines[-4])
    assert re.fullmatch(rf"chain: {times} M=640 C=256 F=1024", lines[-3])
    assert re.fullmatch(r"cublas products \(x @ w1, g @ w2; unused by the port\): "
                        r"device [0-9.]+ ms", lines[-2])
    assert json.loads(lines[-1]) == json.loads(json.dumps(result))
    assert _launches("swiglu_fwd") > before
    assert set(result["tiles"]) == set(sw.ROW_TILES) and result["chain"]["ms"] > 0
    assert all(r["ms"] > 0 and r["max_err"] < 0.1 for r in result["tiles"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,F", [(6404, 512, 2048), (301, 512, 1960), (77, 508, 1996),
                                   (1, 512, 2048)])
def test_swiglu_kernel_at_conformer_l_width(cuda, M, C, F):
    """Conformer-L's FFN (C=512) and its ragged neighbours at tm=64: every
    row finite in a block the allocator last held as NaN, within 2^-7
    max|plain|, two calls bit-identical."""
    rng = np.random.default_rng(M + C)
    args = sw.args_from_numpy(*(rng.standard_normal(shape).astype(np.float32) * scale
                                for shape, scale in (((M, C), 1.0), ((C, 2 * F), 0.05),
                                                     ((1, 2 * F), 0.1), ((F, C), 0.05),
                                                     ((1, C), 0.1))), cuda)
    want = swiglu_fused_ref(*args).float()
    poison = torch.full((M, C), float("nan"), dtype=torch.bfloat16, device=cuda)
    del poison
    got = sw.swiglu(*args, tm=64)
    again = sw.swiglu(*args, tm=64)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(dim=1).all()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2.0 ** -7 * want.abs().max().item())


@pytest.mark.cuda
def test_data_parallel_ranks_launch_the_kernels_on_one_card(cuda, tmp_path):
    """data=2 over gloo with both ranks on the card (tests/torch_parallel_worker.py):
    each rank launches the attention and CTC kernels on its rows, the
    replicas agree bit for bit, and the losses are the one-process run's
    on the global batch (fp32: 1e-4 relative)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as W
    from turkish_asr_torch.models.conformer import ModelConfig, init_model

    cfg = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=1, n_classes=56, dropout=0.0)
    torch.save(init_model(ModelConfig(**cfg), torch.Generator().manual_seed(0)).state_dict(),
               tmp_path / "init.pt")
    rng = np.random.default_rng(0)
    batches = [{"waveforms": (rng.standard_normal((4, 8000)) * 0.1).astype(np.float32),
                "wav_lengths": np.asarray([8000, 6500, 5000, 7300], np.int32),
                "targets": rng.integers(2, 30, (4, 4)).astype(np.int32),
                "target_lengths": np.asarray([4, 3, 2, 4], np.int32),
                "sample_mask": np.ones(4, np.float32)} for _ in range(2)]
    torch.save([[b] for b in batches], tmp_path / "one.pt")
    torch.save([[{k: v[d::2] for k, v in b.items()} for d in range(2)] for b in batches],
               tmp_path / "two.pt")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one = W.train(str(tmp_path), cfg, str(tmp_path / "init.pt"), str(tmp_path / "one.pt"),
                  device="cuda")
    ranks = W.run_ranks(tmp_path, "train", 2, timeout=300, cfg=cfg,
                        init=str(tmp_path / "init.pt"), batches=str(tmp_path / "two.pt"),
                        mesh_spec="data=2", device="cuda")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
    for k, v in ranks[1]["local_state"].items():
        assert torch.equal(v, ranks[0]["local_state"][k]), k


@pytest.mark.cuda
def test_attention_kernel_is_the_default_and_kernel_off_launches_none(cuda):
    """The model's default core launches the attention kernels (forward in
    eval; forward and backward in a training step); ``attn_kernel=False``
    (the bench's kernel-off runs) launches neither, and its fp32 logits are
    the kernel's within chip_smoke.py's served fp32 bar (1e-3)."""
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.1)
    model = init_model(cfg, torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 203, 80))
                         .astype(np.float32)).to(cuda)
    lens = torch.tensor([203, 150], device=cuda)
    logits = {}
    for kernel in (True, False):
        before = (_launches("flash_attention_fwd"), _launches("flash_attention_bwd"))
        with torch.no_grad():
            logits[kernel] = model(x, lens, torch.float32, attn_kernel=kernel)
        out, _ = model(x, lens, torch.bfloat16, train=True, seed=3, remat="full",
                       attn_kernel=kernel)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        fwd = _launches("flash_attention_fwd") - before[0]
        bwd = _launches("flash_attention_bwd") - before[1]
        if kernel:
            assert (fwd, bwd) == (3 * cfg.n_blocks, cfg.n_blocks)
        else:
            assert (fwd, bwd) == (0, 0)
    assert (logits[True] - logits[False]).abs().max().item() < 1e-3
