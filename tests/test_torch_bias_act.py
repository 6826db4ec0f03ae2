"""The bias epilogue on the CPU (``ops/bias_act.py``): the plain chain is the
model's arithmetic before the kernel, op for op; the op's CPU implementation
is the plain chain; which path a call takes; the op's fake shapes. The
kernel itself is held to the plain chain bit for bit on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.ops import bias_act as ba
from turkish_asr_torch.utils import tracing

TAILS = ("none", "relu", "silu", "glu_mask", "bn_silu")


def _case(tail, dtype=torch.bfloat16, seed=0):
    """(x, bias, mask, bn) of a small call: rows (3, 7, C), the subsample's
    (2, C, 5, 3) for relu, a depthwise output (2, C, 9) for bn_silu."""
    g = torch.Generator().manual_seed(seed)
    C = 12
    shape = {"relu": (2, C, 5, 3), "glu_mask": (3, 7, 2 * C), "bn_silu": (2, C, 9)}.get(
        tail, (3, 7, C))
    x = torch.randn(shape, generator=g).to(dtype)
    bias = torch.rand(shape[-1] if tail == "glu_mask" else C, generator=g) - 0.5
    mask = torch.arange(7)[None, :] < torch.tensor([7, 4, 0])[:, None] if tail == "glu_mask" \
        else None
    bn = None
    if tail == "bn_silu":
        bn = torch.nn.BatchNorm1d(C)
        with torch.no_grad():
            bn.running_mean.copy_(0.3 * torch.randn(C, generator=g))
            bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
            bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
            bn.bias.copy_(0.3 * torch.randn(C, generator=g))
    return x, bias, mask, bn


def _dim(tail):
    return 1 if tail in ("relu", "bn_silu") else -1


def _params(bn):
    return None if bn is None else (bn.running_mean, torch.rsqrt(bn.running_var + bn.eps),
                                    bn.weight, bn.bias)


def _model_chain(x, bias, cd, tail, mask, bn):
    """The model's arithmetic at each site before the bias epilogue, as it
    was written: ``add_bias`` and the tail's own ops."""
    def add_bias(out, b):
        return (out.float() + b.float()).to(cd)

    if tail == "relu":  # the subsample: act(add_bias(h, conv.bias[:, None, None]))
        return torch.nn.ReLU()(add_bias(x, bias[:, None, None]))
    if tail == "silu":  # SwishFeedForward: F.silu(dense(linear1, x))
        return F.silu(add_bias(x, bias))
    if tail == "glu_mask":  # the conv module's pointwise 1 and GLU
        d = x.shape[-1] // 2
        h = add_bias(x, bias)
        h = h[..., :d] * torch.sigmoid(h[..., d:])
        return torch.where(mask[:, :, None], h, 0)
    if tail == "bn_silu":  # its depthwise bias, BatchNorm in eval, SiLU
        h = add_bias(x.transpose(1, 2), bias)
        hn = (h.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        return F.silu((hn * bn.weight + bn.bias).to(cd))
    return add_bias(x, bias)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tail", TAILS)
def test_plain_chain_is_the_models_arithmetic(tail, dtype):
    x, bias, mask, bn = _case(tail, dtype)
    with torch.no_grad():
        got = ba.bias_act_plain(x, bias, dtype, tail, _dim(tail), mask, _params(bn))
        want = _model_chain(x, bias, dtype, tail, mask, bn)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tail", TAILS)
def test_op_on_cpu_is_the_plain_chain(tail, dtype):
    x, bias, mask, bn = _case(tail, dtype, seed=1)
    params = _params(bn)
    with torch.no_grad():
        got = torch.ops.turkish_asr_torch.bias_act(x, bias, tail, _dim(tail), mask,
                                                   *(params or (None,) * 4))
        want = ba.bias_act_plain(x, bias, dtype, tail, _dim(tail), mask, params)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tail", TAILS)
def test_op_fake_gives_the_output_shape(tail):
    x, bias, mask, bn = _case(tail)
    params = _params(bn)
    want = ba.bias_act_plain(x, bias, torch.bfloat16, tail, _dim(tail), mask, params)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fx, fb = mode.from_tensor(x), mode.from_tensor(bias)
        fm = None if mask is None else mode.from_tensor(mask)
        fp = [None] * 4 if params is None else [mode.from_tensor(t.detach()) for t in params]
        out = torch.ops.turkish_asr_torch.bias_act(fx, fb, tail, _dim(tail), fm, *fp)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.stride() == want.stride()


def _layouts(tail):
    """(name, x) of a tail's case in each layout a product may have: dense in
    any order of dimensions, or a view with gaps."""
    x, *_ = _case(tail, seed=4)
    if tail == "bn_silu":  # the depthwise output channel-major or -last, the even kernel's view
        last = x.transpose(1, 2).contiguous().transpose(1, 2)
        return [("channel_major", x), ("channel_last", last), ("skipped", x[..., 1:]),
                ("channel_last_skipped", last[..., 1:])]
    if tail == "glu_mask":
        return [("contiguous", x)]
    if tail == "relu":
        last = x.contiguous(memory_format=torch.channels_last)
        return [("contiguous", x), ("channels_last", last), ("sliced", x[..., 1:]),
                ("channels_last_sliced", last[:, :, 1:])]
    return [("contiguous", x), ("transposed", x.transpose(1, 2).contiguous().transpose(1, 2)),
            ("sliced", x[:, 1:]), ("transposed_sliced", x[:, 1:].transpose(0, 1))]


@pytest.mark.parametrize("tail", TAILS)
def test_op_gives_the_plain_chains_layout(tail):
    """One layout rule: the fake implementation's strides (those of the
    kernel's output on the card) are the plain chain's, in every layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, bias, mask, bn = _case(tail, seed=4)
    params = _params(bn)
    for name, x in _layouts(tail):
        dim = _dim(tail) if name != "transposed_sliced" else -1
        b = bias if name != "transposed_sliced" else torch.rand(x.shape[-1])
        m = mask if mask is None or mask.shape == x.shape[:-1] else None
        want = ba.bias_act_plain(x, b, torch.bfloat16, tail, dim, m, params)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fp = [None] * 4 if params is None else [mode.from_tensor(t.detach()) for t in params]
            out = torch.ops.turkish_asr_torch.bias_act(
                mode.from_tensor(x), mode.from_tensor(b), tail, dim,
                None if m is None else mode.from_tensor(m), *fp)
        assert (out.shape, out.stride()) == (want.shape, want.stride()), name


@pytest.mark.parametrize("name,shape,strides,dim,want", [
    ("rows", (6, 5), (5, 1), -1, (6, 5, 1)),
    ("planes", (2, 3, 4, 5), (60, 20, 5, 1), 1, (2, 3, 20)),
    ("channels_last", (2, 3, 4, 5), (60, 1, 15, 3), 1, (40, 3, 1)),
    ("transposed", (2, 7, 3), (21, 1, 7), -1, (2, 3, 7)),
    ("size_one", (1, 4, 1, 6), (6, 1, 99, 4), 1, (6, 4, 1)),
    ("gap", (2, 3, 4), (24, 8, 1), -1, None),
])
def test_dense_layout_reads_any_order_of_dimensions(name, shape, strides, dim, want):
    x = torch.empty_strided(shape, strides)
    assert ba._dense_layout(x, dim) == want, name


_DTYPE_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,compute", _DTYPE_PAIRS)
@pytest.mark.parametrize("tail", TAILS)
def test_op_backward_is_the_plain_chains(tail, dtype, compute):
    """The op's backward (the card's path with a gradient to record) gives
    the plain chain's gradients bit for bit: of the product, the bias and,
    for bn_silu, BatchNorm's weight and shift."""
    x, bias, mask, bn = _case(tail, dtype, seed=5)

    def grads(run):
        xs = x.detach().clone().requires_grad_(True)
        bs = bias.detach().clone().requires_grad_(True)
        w = s = None
        if bn is not None:
            w = bn.weight.detach().clone().requires_grad_(True)
            s = bn.bias.detach().clone().requires_grad_(True)
        params = None if bn is None else (bn.running_mean, torch.rsqrt(bn.running_var + bn.eps),
                                          w, s)
        out = run(xs, bs, params)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(out.dtype)
        out.backward(cot)
        return [t.grad for t in (xs, bs, w, s) if t is not None], out.detach()

    got, got_out = grads(lambda xs, bs, p: ba.bias_act_op(
        xs, bs, tail, _dim(tail), mask, *(p or (None,) * 4), compute))
    want, want_out = grads(lambda xs, bs, p: ba.bias_act_plain(
        xs, bs, compute, tail, _dim(tail), mask, p))
    assert torch.equal(got_out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("tail", TAILS)
def test_op_passes_opcheck(tail):
    x, bias, mask, bn = _case(tail, seed=2)
    params = _params(bn)
    args = (x, bias, tail, _dim(tail), mask,
            *([None] * 4 if params is None else [t.detach() for t in params]))
    torch.library.opcheck(ba.bias_act_op, args)


@pytest.mark.parametrize("tail", TAILS)
def test_op_with_gradients_passes_opcheck(tail):
    x, bias, mask, bn = _case(tail, torch.float32, seed=8)
    params = _params(bn)
    args = (x.requires_grad_(True), bias.requires_grad_(True), tail, _dim(tail), mask,
            *([None] * 4 if params is None else [t.detach().requires_grad_(i >= 2)
                                                 for i, t in enumerate(params)]))
    torch.library.opcheck(ba.bias_act_op, args)


@pytest.mark.parametrize("device,dtype,compute,takes", [
    ("cuda", torch.bfloat16, torch.bfloat16, True),
    ("cuda", torch.float32, torch.float32, True),     # fp32 compute
    ("cuda", torch.float32, torch.bfloat16, True),    # a row-parallel fp32 sum
    ("cpu", torch.bfloat16, torch.bfloat16, False),   # the CPU: the plain chain
    ("cpu", torch.float32, torch.float32, False),
])
def test_kernel_takes_what_the_call_shows(device, dtype, compute, takes):
    assert ba.kernel_takes(device, dtype, compute) is takes


@pytest.mark.parametrize("dtype,compute", [(torch.bfloat16, torch.float32),
                                           (torch.float16, torch.float16),
                                           (torch.float32, torch.float16)])
def test_the_card_refuses_a_pair_of_dtypes_the_kernel_lacks(dtype, compute):
    """On the card every call is the kernel's or raises: no silent plain
    chain."""
    with pytest.raises(ValueError, match="bias_act kernel takes"):
        ba.kernel_takes("cuda", dtype, compute)
    assert ba.kernel_takes("cpu", dtype, compute) is False


@pytest.mark.parametrize("case", ["cpu_bf16", "cpu_fp32", "grad"])
@pytest.mark.parametrize("tail", TAILS)
def test_plain_calls_count_nothing(tail, case):
    """On the CPU a bf16 or an fp32 call and one that records a gradient take
    the plain chain: the same values, no launch counted, and gradients flow."""
    dtype = torch.float32 if case == "cpu_fp32" else torch.bfloat16
    x, bias, mask, bn = _case(tail, dtype, seed=3)
    if case == "grad":
        bias.requires_grad_(True)
    before = tracing.counters()["bias_act"]
    with torch.no_grad():
        want = ba.bias_act_plain(x, bias, dtype, tail, _dim(tail), mask, _params(bn))
    got = ba.bias_act(x, bias, dtype, tail, dim=_dim(tail), mask=mask, bn=bn)
    assert torch.equal(got.detach(), want)
    assert tracing.counters()["bias_act"] == before
    if case == "grad":
        got.float().sum().backward()
        assert bias.grad is not None and torch.isfinite(bias.grad).all()


def test_an_unknown_tail_is_refused():
    x, bias, _, _ = _case("none")
    with pytest.raises(ValueError, match="tail must be one of"):
        ba.bias_act(x, bias, torch.bfloat16, "gelu")


@pytest.mark.parametrize("block,kernel", [("flagship", 31), ("conformer", 8)])
def test_a_cpu_forward_counts_no_launch(block, kernel):
    cfg = ModelConfig(n_mels=80, d_model=32, n_heads=2, n_blocks=2, n_classes=19,
                      conv_kernel_size=kernel, block=block)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 57, 80, generator=torch.Generator().manual_seed(1))
    before = tracing.counters()["bias_act"]
    with torch.inference_mode():
        logits = model(x, torch.tensor([57, 30]), torch.bfloat16)
    assert torch.isfinite(logits).all()
    assert tracing.counters()["bias_act"] == before


@pytest.mark.parametrize("remat", [False, "full", "dots"])
def test_a_training_step_through_the_op_is_the_plain_chains(remat):
    """A training step whose every biased site goes through the op (as on
    the card, where a gradient to record takes it; here its CPU
    implementation and its backward): loss and gradients equal the plain
    chain's bit for bit, with and without recomputation in the backward."""
    from unittest import mock

    cfg = ModelConfig(n_mels=80, d_model=32, n_heads=2, n_blocks=2, n_classes=19, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 57, 80, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([57, 30])
    calls = []
    op = ba.bias_act_op

    def counted(*args):
        calls.append(args[2])
        return op(*args)

    def step():
        model.zero_grad(set_to_none=True)
        out, _ = model(x, lens, torch.bfloat16, train=True, seed=3, remat=remat)
        out.float().square().mean().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    with mock.patch.object(ba, "kernel_takes", lambda *a: True), \
            mock.patch.object(ba, "bias_act_op", counted):
        out, grads = step()
    plain_out, plain_grads = step()
    assert calls.count("glu_mask") >= cfg.n_blocks and "silu" in calls
    assert torch.equal(out, plain_out)
    assert sum(g is not None for g in grads.values()) > 30
    for k, g in grads.items():
        want = plain_grads[k]
        assert (g is None and want is None) or torch.equal(g, want), k
