"""The bias epilogue of the model's products: ``bias_act``.

Every linear layer and convolution of the model ends the same way: the
product in the compute dtype, its fp32 bias added, the sum rounded back to
the compute dtype, then the elementwise tail of the call site (``TAILS``):

- ``none``, ``relu``, ``silu``: the biased tensor, activated, any shape, the
  bias along ``dim`` (the dense layers' rows, the subsample's (N, C, H, W));
- ``glu_mask``: (..., 2C) -> (..., C), ``a * sigmoid(g)`` of the biased
  halves, then the frames off ``mask`` (...,) zeroed (the conv module's
  pointwise 1 and GLU);
- ``bn_silu``: the depthwise convolution's (B, C, T) -> (B, T, C),
  BatchNorm on the running statistics of ``bn``, then SiLU.

``bias_act_plain`` is that chain as plain PyTorch, op for op as the model
wrote it before this kernel. Which implementation runs follows from the
tensor's device:

- a CUDA tensor: the hand-written kernel (``csrc/bias_act.cu``), one launch
  a call, counted as ``bias_act`` in ``utils/tracing.py``, with the plain
  chain's bits and output layout. It takes a bf16 or fp32 product in its own
  compute dtype and an fp32 sum in bf16 (a row-parallel layer's); it refuses
  any other pair, and a ``glu_mask`` product that is not contiguous, with a
  ``ValueError``. With no gradient to record, in eager mode, it is launched
  through its ctypes entry point and the pointwise tails write their result
  over ``x`` (dense), which the call consumes. Under ``torch.export`` or
  ``torch.compile``, or with a gradient to record, it is the op
  ``turkish_asr_torch::bias_act`` (out of place; its fake implementation
  gives the output's shape and strides), whose backward is the plain chain's
  own, op for op, on what the chain saves or on its forward recomputed;
- any other tensor: the plain chain, which is also the op's CPU
  implementation.
"""

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from turkish_asr_torch.ops._build import load_library
from turkish_asr_torch.utils import tracing

SOURCES = ("bias_act.cu",)
TAILS = ("none", "relu", "silu", "glu_mask", "bn_silu")
# the C entry points' codes: tails, and (product, compute) dtypes
_POINTWISE = {"none": 0, "relu": 1, "silu": 2}
_DTYPES = {(torch.bfloat16, torch.bfloat16): 0, (torch.float32, torch.float32): 1,
           (torch.float32, torch.bfloat16): 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"bias_act_pointwise": [_P, _P, _P, _I, _I, _L, _I, _L, _P],
             "bias_act_glu": [_P, _P, _P, _P, _I, _L, _I, _P],
             "bias_act_bn_silu": [_P] * 7 + [_I] * 4 + [_L] * 6 + [_P]}
_entry_points = {}
tracing.count("bias_act", 0)


def load_kernel(symbol="bias_act_pointwise"):
    """The C entry point ``symbol`` (``_ARGTYPES``), building the library at first use."""
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(load_library("bias_act", SOURCES), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[symbol]
        _entry_points[symbol] = fn
    return fn


def _biased(x, bias, compute_dtype, dim=-1):
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.float() + bias.float().view(shape)).to(compute_dtype)


def bias_act_plain(x, bias, compute_dtype, tail="none", dim=-1, mask=None, bn=None):
    """The chain the kernel replaces, as plain PyTorch (``bias_act`` states
    the function); ``bn`` is (running mean, rsqrt(running var + eps),
    weight, bias) for ``bn_silu``."""
    if tail == "glu_mask":
        h = _biased(x, bias, compute_dtype)
        C = h.shape[-1] // 2
        h = h[..., :C] * torch.sigmoid(h[..., C:])
        return h if mask is None else torch.where(mask[..., None], h, 0)
    if tail == "bn_silu":
        mean, rstd, weight, shift = bn
        h = _biased(x.transpose(1, 2), bias, compute_dtype)
        return F.silu(((h.float() - mean) * rstd * weight + shift).to(compute_dtype))
    h = _biased(x, bias, compute_dtype, dim)
    return F.relu(h) if tail == "relu" else F.silu(h) if tail == "silu" else h


def kernel_takes(device_type, dtype, compute_dtype):
    """Whether the kernel computes a call on a ``device_type`` tensor of
    ``dtype`` in ``compute_dtype``: every CUDA call, none elsewhere; a CUDA
    call of a pair of dtypes the kernel lacks raises ``ValueError``."""
    if device_type != "cuda":
        return False
    if (dtype, compute_dtype) not in _DTYPES:
        raise ValueError(f"the bias_act kernel takes a bf16 or fp32 product in its own compute "
                         f"dtype or an fp32 one in bf16, got {dtype} in {compute_dtype}")
    return True


def _bn_params(bn):
    return bn.running_mean, torch.rsqrt(bn.running_var + bn.eps), bn.weight, bn.bias


def bias_act(x, bias, compute_dtype, tail="none", *, dim=-1, mask=None, bn=None):
    """A product ``x`` with its ``bias`` (fp32 or not; C values along
    ``dim``, along the last dim for ``glu_mask`` (2C values) and dim 1 for
    ``bn_silu``) added in fp32, rounded to ``compute_dtype``, then ``tail``
    (module docstring): ``mask`` (bool, x's shape without its last dim) for
    ``glu_mask``, the ``nn.BatchNorm1d`` ``bn`` for ``bn_silu``. On the
    kernel's eager path the pointwise tails write the result over ``x``."""
    if tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {tail!r}")
    params = _bn_params(bn) if tail == "bn_silu" else None
    if not kernel_takes(x.device.type, x.dtype, compute_dtype):
        return bias_act_plain(x, bias, compute_dtype, tail, dim, mask, params)
    if torch.compiler.is_compiling() or (torch.is_grad_enabled() and (
            x.requires_grad or bias.requires_grad
            or (params is not None and any(t.requires_grad for t in params)))):
        return bias_act_op(x, bias, tail, dim, mask, *(params or (None,) * 4), compute_dtype)
    return _launch(x, bias, compute_dtype, tail, dim, mask, params, in_place=True)


def _dense_layout(x, dim):
    """(outer, C, inner) of x in its memory order, the channel ``dim`` between
    them, if x is dense (any order of dimensions); None if it is not."""
    dim %= x.dim()
    if x.is_contiguous():
        return math.prod(x.shape[:dim]), x.shape[dim], math.prod(x.shape[dim + 1:])
    order = sorted(range(x.dim()), key=x.stride, reverse=True)
    if not x.permute(order).is_contiguous():
        return None
    at = order.index(dim)
    return (math.prod(x.shape[d] for d in order[:at]), x.shape[dim],
            math.prod(x.shape[d] for d in order[at + 1:]))


def _output(x, tail, compute_dtype):
    """An empty output of ``tail`` for x in the plain chain's layout (a new
    (..., C) for glu_mask; bn_silu's (B, T, C) and the pointwise tails' in
    x's order of dimensions)."""
    if tail == "glu_mask":
        return x.new_empty((*x.shape[:-1], x.shape[-1] // 2), dtype=compute_dtype)
    return torch.empty_like(x.transpose(1, 2) if tail == "bn_silu" else x, dtype=compute_dtype)


def _aligned(t):
    """fp32 t, contiguous and 16-byte aligned (the kernels read float4s)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, bias, compute_dtype, tail, dim, mask, bn, in_place):
    """The kernel's one launch for a CUDA ``x``; returns the output: the
    pointwise tails' over x where ``in_place`` and the dtypes agree, else a
    new tensor in the plain chain's layout."""
    code = _DTYPES[x.dtype, compute_dtype]
    if any(t is not None and t.device != x.device for t in (bias, mask, *(bn or ()))):
        raise ValueError(f"bias, mask and bn must be on {x.device}")
    width = x.shape[-1] if tail == "glu_mask" else x.shape[1 if tail == "bn_silu" else dim]
    if bias.numel() != width:
        raise ValueError(f"bias must hold {width} values, got {tuple(bias.shape)}")
    b = _aligned(bias)
    # the raw handle: building a Stream object costs the host ~5 us a call on the H100 host
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if tail == "glu_mask":
        if not x.is_contiguous():
            raise ValueError(f"the glu_mask tail takes a contiguous (..., 2C) product, got "
                             f"strides {x.stride()}")
        if width % 2:
            raise ValueError(f"the glu_mask tail takes an even width 2C, got {width}")
        if mask is not None and (mask.dtype != torch.bool or mask.shape != x.shape[:-1]):
            raise ValueError(f"mask must be bool {tuple(x.shape[:-1])}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        m = None if mask is None else mask.contiguous().view(torch.uint8)
        y = _output(x, tail, compute_dtype)
        args = ("bias_act_glu", x.data_ptr(), y.data_ptr(), b.data_ptr(),
                None if m is None else m.data_ptr(), code, x.shape[:-1].numel(), width // 2,
                stream)
    elif tail == "bn_silu":
        if x.dim() != 3:
            raise ValueError(f"the bn_silu tail takes a (B, C, T) product, got {tuple(x.shape)}")
        B, C, T = x.shape
        y = _output(x, tail, compute_dtype)
        mean, rstd, weight, shift = (_aligned(t) for t in bn)
        args = ("bias_act_bn_silu", x.data_ptr(), y.data_ptr(), b.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), weight.data_ptr(), shift.data_ptr(), code, B, C, T, *x.stride(),
                *y.stride(), stream)
    else:
        layout = _dense_layout(x, dim)
        if layout is None:  # a dense copy in x's order of dimensions, which the call owns
            x, in_place = torch.empty_like(x).copy_(x), True
            layout = _dense_layout(x, dim)
        y = x if in_place and x.dtype == compute_dtype else _output(x, tail, compute_dtype)
        args = ("bias_act_pointwise", x.data_ptr(), y.data_ptr(), b.data_ptr(),
                _POINTWISE[tail], code, *layout, stream)
    if y.numel() == 0:
        return y
    fn = load_kernel(args[0])
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args[1:])
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args[1:])
    if rc != 0:
        raise RuntimeError(f"{args[0]} launch failed with CUDA error {rc}")
    tracing.count("bias_act")
    return y


@torch.library.custom_op("turkish_asr_torch::bias_act", mutates_args=(), device_types="cpu")
def bias_act_op(x: torch.Tensor, bias: torch.Tensor, tail: str, dim: int,
                mask: Optional[torch.Tensor], bn_mean: Optional[torch.Tensor],
                bn_rstd: Optional[torch.Tensor], bn_weight: Optional[torch.Tensor],
                bn_shift: Optional[torch.Tensor],
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.ops.turkish_asr_torch.bias_act``: ``bias_act`` in
    ``compute_dtype`` (x's dtype if None), out of place, with ``bn`` as its
    four tensors (None but for ``bn_silu``), differentiable. On CPU tensors
    the plain chain; on CUDA tensors the kernel."""
    bn = None if bn_mean is None else (bn_mean, bn_rstd, bn_weight, bn_shift)
    return bias_act_plain(x, bias, compute_dtype or x.dtype, tail, dim, mask, bn)


@bias_act_op.register_kernel("cuda")
def _op_cuda(x, bias, tail, dim, mask, bn_mean, bn_rstd, bn_weight, bn_shift,
             compute_dtype=None):
    bn = None if bn_mean is None else (bn_mean, bn_rstd, bn_weight, bn_shift)
    cd = compute_dtype or x.dtype
    kernel_takes(x.device.type, x.dtype, cd)  # raises for a pair of dtypes the kernel lacks
    return _launch(x, bias, cd, tail, dim, mask, bn, in_place=False)


@bias_act_op.register_fake
def _op_fake(x, bias, tail, dim, mask, bn_mean, bn_rstd, bn_weight, bn_shift,
             compute_dtype=None):
    return _output(x, tail, compute_dtype or x.dtype)


def _setup_context(ctx, inputs, output):
    x, bias, tail, dim, mask, mean, rstd, weight, shift, compute_dtype = inputs
    ctx.tail, ctx.dim, ctx.compute_dtype = tail, dim, compute_dtype or x.dtype
    ctx.x_dtype, ctx.x_dims = x.dtype, x.dim()
    ctx.bias_shape, ctx.bias_dtype = bias.shape, bias.dtype
    if tail == "relu":  # what the plain chain saves: relu's output
        ctx.save_for_backward(output)
    elif tail != "none":  # the chain's forward, recomputed in the backward
        ctx.save_for_backward(x, bias, mask, mean, rstd, weight, shift)


def _backward(ctx, grad):
    """The plain chain's backward, op for op: for none and relu written out
    (``.to(cd)``'s, the fp32 add's with its broadcast bias summed by
    ``sum_to_size`` as autograd sums it, ``.float()``'s; relu's
    ``threshold_backward``), for the others autograd's own on the chain's
    forward recomputed from the saved product."""
    needs = ctx.needs_input_grad
    if ctx.tail in ("none", "relu"):
        if ctx.tail == "relu":
            grad = torch.ops.aten.threshold_backward(grad, ctx.saved_tensors[0], 0)
        g32 = grad.float()
        shape = [1] * ctx.x_dims
        shape[ctx.dim] = -1
        gx = g32.to(ctx.x_dtype) if needs[0] else None
        gb = None
        if needs[1]:
            gb = g32.sum_to_size(torch.Size(g32.shape[d] if s == -1 else 1
                                            for d, s in enumerate(shape)))
            gb = gb.view(ctx.bias_shape).to(ctx.bias_dtype)
        return gx, gb, None, None, None, None, None, None, None, None
    saved = ctx.saved_tensors
    position = (0, 1, 4, 5, 6, 7, 8)  # of each saved tensor among the op's inputs
    with torch.enable_grad():
        leaves = [None if t is None
                  else t.detach().requires_grad_(needs[i] and t.is_floating_point())
                  for t, i in zip(saved, position)]
        x, bias, mask, *bn = leaves
        out = bias_act_plain(x, bias, ctx.compute_dtype, ctx.tail, ctx.dim, mask,
                             None if bn[0] is None else tuple(bn))
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
    grads = [None] * 10
    for t, i in zip(leaves, position):
        if t is not None and t.requires_grad:
            grads[i] = next(got)
    return tuple(grads)


bias_act_op.register_autograd(_backward, setup_context=_setup_context)
