"""Conformer-CTC encoder in PyTorch, inference and training.

Counterpart of turkish_asr_tpu/models/conformer.py (``apply_model`` :361,
``conformer_block`` :285, ``batch_norm`` :129, ``swiglu_ffn`` :187). The module tree and
parameter names are those of the reference ``TurkishASRModel``, i.e. the
keys turkish_asr_tpu/utils/torch_export.py writes, so a ``.pt`` from
``export_model.py --format torch`` loads with ``strict=True`` (the dead
``norm_conv`` GroupNorm included). The torch modules hold the parameters;
the arithmetic is written out so its cast points follow the JAX package:

- GroupNorm: fp32 statistics over (time, channels of the group), output in
  the input dtype; padding leaks into the statistics unless ``masked_norm``.
- BatchNorm: running statistics in eval; in training the batch
  statistics (biased variance) normalize and the new running estimate
  (unbiased variance, momentum 0.1) is returned, not written, so the
  trainer commits it once per applied step, never in a recompute and never
  on a skipped step (JAX returns it functionally for the same reason).
- dense layers and convolutions: the product in the compute dtype, the
  bias added in fp32, then cast back, with the elementwise tail after it
  (``ops.bias_act``: one hand-written kernel on the card in bf16).
- the padding mask is ``arange(T') <`` the subsample's ``frames`` of the
  input lengths (``input_lengths // 4`` for the reference's subsample); the
  subsample output flattens channel-major, (C, F).
- training dropout (rate ``cfg.dropout``) after the SwiGLU gate product
  and after its output projection, and on the attention weights inside the
  attention kernel. Every mask is a pure function of (step seed, block,
  site): ``torch.utils.checkpoint`` restores no explicit generator, so a
  per-block recompute must draw its masks from the same seeds as the first
  forward.

On a mesh (``parallel/mesh.py``; ``shard_model`` hands every module the
mesh and its parameter slices) the model computes the one-process model's
function, with the collectives of ``parallel/collectives.py``:

- ``data``: BatchNorm statistics are summed over the (data, seq) ranks;
  the data rank is mixed into every dropout seed (``shard_seed``).
- ``model``: the SwiGLU in-projection is column-parallel and its
  out-projection row-parallel, with one all-reduce after it and the bias
  added once; attention's ``q`` holds this rank's heads and ``out`` is
  row-parallel (``models/attention.py``).
- ``seq``: the subsample convolutions run on the full input; the ``T'``
  frames are split (unevenly when they do not divide) and gathered again
  as logits, so CTC sees full rows. GroupNorm sums over the seq ranks, the
  depthwise convolution takes a halo of (k-1)/2 frames on each side.
- dropout draws each mask at the one-process shape and takes this rank's
  slice, so replicated activations get the same mask on every rank.

``ModelConfig.block`` names a ``Block`` in ``BLOCKS``, where a new
architecture goes. ``"flagship"`` (the default) is the reference model's
above. ``"conformer"`` is Conformer (L)'s (Gulati et al. 2020,
arXiv:2005.08100), every module pre-norm:

- ``x1 = x + FFN(x) / 2``, FFN = LayerNorm -> Linear(d, 4d) -> Swish ->
  Linear(4d, d) (``ff1``, ``norm_ff1``; ``ff2``, ``norm_ff2`` after the conv)
- ``x2 = x1 + MHSA_rel(LayerNorm(x1))`` (``norm_attn``, ``attn``:
  ``models/attention.RelPositionMultiHeadAttention``)
- ``x3 = x2 + Conv(x2)``, Conv = LayerNorm -> pointwise(2d) -> GLU ->
  padded frames zeroed -> depthwise(k) -> BatchNorm -> Swish -> pointwise
- ``y = LayerNorm(x3 + FFN(x3) / 2)`` (``final_norm``)

LayerNorm takes fp32 statistics and returns the input's dtype, as
``group_norm``. The depthwise convolution pads as TensorFlow's ``SAME``
(the paper's Lingvo): (k-1)//2 frames before and k//2 after, 15 and 16 for
k = 32. With padded frames zeroed before it, LayerNorm per frame, BatchNorm
on running statistics and positions that depend only on i - j, a file's
logits do not depend on its bucket or its batch. The subsample takes ReLU.
The block serves only (bf16 only on CUDA): it refuses a mesh and training.

``ModelConfig.subsample`` names a subsample in ``SUBSAMPLES``: ``"conv4"``
(the default, the reference's two stride-2 convolutions) or
``"dw_striding8"``, NeMo's depthwise-separable subsample by 8 of
FastConformer (Rekesh et al. 2023, arXiv:2305.05084; Parakeet-CTC 1.1B is 42
``"conformer"`` blocks of d 1024 behind it). Each subsample owns its valid
frames' arithmetic (``frames``), which the mask and ``ASRInference`` take.
"""

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from turkish_asr_torch.models.attention import (
    MultiQueryAttention, RelPositionMultiHeadAttention, dense, in_dense_product)
from turkish_asr_torch.ops.bias_act import bias_act
from turkish_asr_torch.parallel.collectives import all_gather, all_reduce, copy_to, halo
from turkish_asr_torch.parallel.mesh import axis_group, seq_bounds, shard_seed
from turkish_asr_torch.utils import tracing


@dataclass(frozen=True)
class ModelConfig:
    n_mels: int = 80
    d_model: int = 256
    n_heads: int = 4
    n_blocks: int = 8
    n_classes: int = 31
    dropout: float = 0.1
    conv_kernel_size: int = 31
    use_mqa: bool = True
    ff_mult: int = 4
    # Exclude padded frames from GroupNorm/BatchNorm statistics (opt-in;
    # the reference lets padding leak into them).
    masked_norm: bool = False
    # a key of BLOCKS: "flagship" (the reference model's block) or "conformer"
    # (Conformer (L)'s: LayerNorm, Swish, relative-position attention; serving only).
    block: str = "flagship"
    # a key of SUBSAMPLES: "conv4" (two stride-2 convolutions) or "dw_striding8"
    # (NeMo's depthwise-separable subsample by 8, FastConformer's)
    subsample: str = "conv4"
    # the subsample's convolution channels; None: d_model
    subsample_channels: Optional[int] = None

    def __post_init__(self):
        if self.block not in BLOCKS:
            raise ValueError(f"block must be one of {tuple(BLOCKS)}, got {self.block!r}")
        if self.subsample not in SUBSAMPLES:
            raise ValueError(f"subsample must be one of {tuple(SUBSAMPLES)}, got "
                             f"{self.subsample!r}")


def groupnorm_groups(num_channels, preferred=32):
    """Reference divisor fallback: first divisor in [32, 16, 8, 4, 2], else 1."""
    if num_channels % preferred == 0:
        return preferred
    for g in (32, 16, 8, 4, 2):
        if num_channels % g == 0:
            return g
    return 1


def group_norm(norm, x, mask=None, eps=1e-5, group=None):
    """GroupNorm on (B, T, C) with fp32 statistics per (sample, group);
    with ``group`` (seq) the frames of every rank of the group count."""
    B, T, C = x.shape
    G = norm.num_groups
    cg = C // G
    xf = x.float()

    def group_sum(per_channel):  # (B, C) -> per-group sums broadcast to (B, C)
        return per_channel.reshape(B, G, cg).sum(-1).repeat_interleave(cg, dim=-1)

    if mask is None and group is None:
        mean = group_sum(xf.sum(dim=1)) / (T * cg)
        d = xf - mean[:, None, :]
        var = group_sum((d * d).sum(dim=1)) / (T * cg)
    else:
        m = x.new_ones((B, T, 1), dtype=torch.float32) if mask is None else mask.float()[:, :, None]
        denom = torch.clamp(all_reduce(m.sum(dim=1), group) * cg, min=1.0)
        mean = group_sum(all_reduce((xf * m).sum(dim=1), group)) / denom
        d = xf - mean[:, None, :]
        var = group_sum(all_reduce((d * d * m).sum(dim=1), group)) / denom
    xn = d * torch.rsqrt(var + eps)[:, None, :]
    return (xn * norm.weight + norm.bias).to(x.dtype)


class TransposeGroupNorm(nn.Module):
    """GroupNorm over the channels of a (B, T, C) input (reference name)."""

    mesh = None

    def __init__(self, d_model):
        super().__init__()
        self.norm = nn.GroupNorm(groupnorm_groups(d_model), d_model)

    def forward(self, x, mask=None):
        return group_norm(self.norm, x, mask, group=axis_group(self.mesh, "seq"))


# Dropout sites of a block; each draws its mask from its own seed.
SITE_FF1_GATE, SITE_FF1_OUT, SITE_ATTN, SITE_FF2_GATE, SITE_FF2_OUT = range(5)


def derive_seed(*parts):
    """A 63-bit seed from integers (splitmix64 over the parts): the same
    parts give the same seed in the first forward and in its recompute."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return h >> 1


def dropout(x, rate, seed, span=None, model=None):
    """JAX ``_dropout``: keep with probability 1 - rate, scale kept values
    by 1/(1 - rate) in x's dtype. The mask comes from a generator seeded
    with ``seed`` on x's device; no dropout for rate 0 or seed None.

    On a mesh x is a slice of the one-process tensor: frames t0:t1 of T
    with ``span`` (t0, t1, T), and this model rank's slice of the last dim
    with ``model``. The mask is drawn at the full shape and sliced."""
    if rate <= 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    shape, index = list(x.shape), [slice(None)] * x.dim()
    if span is not None:
        t0, t1, shape[1] = span
        index[1] = slice(t0, t1)
    if model is not None:
        n = x.shape[-1]
        shape[-1] = n * model.size
        index[-1] = slice(model.index * n, (model.index + 1) * n)
    keep = torch.rand(shape, generator=gen, device=x.device)[tuple(index)] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class SwiGLUFeedForward(nn.Module):
    mesh = None

    def __init__(self, d_model, d_ff):
        super().__init__()
        self.linear1 = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, compute_dtype, rate=0.0, seeds=(None, None), span=None):
        """``seeds``: the dropout seeds after the gate product and after
        the output projection; ``span``: ``dropout``'s. Over "model",
        linear1 holds this rank's units of h1 and of h2 (column-parallel)
        and linear2 the same units of its input (row-parallel)."""
        model = axis_group(self.mesh, "model")
        h = dense(self.linear1, copy_to(x, model), compute_dtype)
        h1, h2 = h.chunk(2, dim=-1)
        h = dropout(F.silu(h1) * h2, rate, seeds[0], span, model)
        return dropout(dense(self.linear2, h, compute_dtype, model), rate, seeds[1], span)


def batch_norm_train(bn, x, mask=None, momentum=0.1, group=None):
    """BatchNorm over (B, T, C) with batch statistics, as
    torch.nn.BatchNorm1d trains: the biased variance normalizes, the
    unbiased variance updates the running estimate. With ``mask`` (B, T)
    the statistics span the valid frames only; with ``group`` (the data x
    seq ranks) the frames of every rank of the group: the sums, the
    centred sum of squares and the count are all-reduced, so the
    statistics are the global batch's, as under pjit. (SyncBatchNorm
    would not do: it ignores the frame mask.)

    Returns (y in x's dtype, (new running mean, new running var)); the
    module's buffers are not touched."""
    xf = x.float()
    if mask is not None or group is not None:
        m = (x.new_ones((*x.shape[:2], 1), dtype=torch.float32) if mask is None
             else mask.float()[:, :, None])
        n = torch.clamp(all_reduce(m.sum(), group), min=1.0)
        mean = all_reduce((xf * m).sum(dim=(0, 1)), group) / n
        var = all_reduce(torch.where(m > 0, (xf - mean) ** 2, 0.0).sum(dim=(0, 1)), group) / n
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    else:
        mean = xf.mean(dim=(0, 1))
        var = ((xf - mean) ** 2).mean(dim=(0, 1))
        n = x.shape[0] * x.shape[1]
        unbiased = var * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * bn.running_mean + momentum * mean
    new_var = (1 - momentum) * bn.running_var + momentum * unbiased
    xn = (xf - mean) * torch.rsqrt(var + bn.eps)
    return (xn * bn.weight + bn.bias).to(x.dtype), (new_mean.detach(), new_var.detach())


class _ConvModule(nn.Module):
    """A conv module's layers after its norm (the subclass's) and their chain."""

    mesh = None

    def __init__(self, norm, d_model, kernel_size, padding):
        super().__init__()
        self.norm = norm
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size, padding=padding,
                                        groups=d_model)
        self.batch_norm = nn.BatchNorm1d(d_model)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)

    def chain(self, h, compute_dtype, mask=None, pre_mask=False, train=False, span=None):
        """Normalized h -> pointwise(2d) -> GLU -> frames off ``mask`` (B, T)
        zeroed (before the pointwise too with ``pre_mask``) -> depthwise ->
        BatchNorm (``train``: the masked batch's statistics; -> (output, new
        running stats)) -> SiLU -> pointwise. Over "seq" (``span``: this
        rank's frames t0:t1 of T) the depthwise takes its padding as halo."""
        cd = compute_dtype
        if pre_mask and mask is not None:
            h = torch.where(mask[:, :, None], h, 0)
        # Pointwise convs are (B, T, C) products with the (O, I, 1) kernel.
        # GLU over channels, then padded frames zeroed (the bias leaks via pw1).
        w1 = self.pointwise_conv1.weight[:, :, 0].to(cd)
        h = bias_act(torch.matmul(h.to(cd), w1.t()), self.pointwise_conv1.bias, cd, "glu_mask",
                     mask=mask)
        dw = self.depthwise_conv
        seq = axis_group(self.mesh, "seq")
        if seq is None:
            h = F.conv1d(h.transpose(1, 2).to(cd), dw.weight.to(cd), padding=dw.padding,
                         groups=dw.groups)
        else:
            sizes = [b - a for a, b in seq_bounds(span[2], seq.size)]
            h = halo(h.to(cd), dw.padding[0], seq, sizes)
            h = F.conv1d(h.transpose(1, 2), dw.weight.to(cd), groups=dw.groups)
        if 2 * dw.padding[0] == dw.kernel_size[0]:  # an even kernel padded k//2 a side
            h = h[..., 1:]
        bn = self.batch_norm
        if train:
            h = bias_act(h.transpose(1, 2), dw.bias, cd)
            h, stats = batch_norm_train(bn, h, mask, group=axis_group(self.mesh, "data", "seq"))
            h = F.silu(h)
        else:
            h = bias_act(h, dw.bias, cd, "bn_silu", bn=bn)  # (B, C, T) -> (B, T, C)
        w2 = self.pointwise_conv2.weight[:, :, 0].to(cd)
        out = bias_act(torch.matmul(h, w2.t()), self.pointwise_conv2.bias, cd)
        return (out, stats) if train else out


class ConformerConvModule(_ConvModule):
    """GroupNorm -> ``chain``, the depthwise padded (k-1)//2 on both sides."""

    def __init__(self, d_model, kernel_size):
        super().__init__(TransposeGroupNorm(d_model), d_model, kernel_size, (kernel_size - 1) // 2)

    def forward(self, x, compute_dtype, norm_mask=None, train=False, span=None):
        return self.chain(self.norm(x, norm_mask), compute_dtype, norm_mask, True, train, span)


class Frames:
    """A forward's valid frames after the subsample, for every block:
    ``mask`` (B, T') bool, or None when all are valid, and ``lengths`` (B,)
    int32 counts clamped to T', made when first read (nothing launched
    for a block that never reads them)."""

    def __init__(self, mask, counts, B, T, device):
        self.mask, self._made_of = mask, (counts, B, T, device)

    @functools.cached_property
    def lengths(self):
        counts, B, T, device = self._made_of
        if counts is None:
            counts = torch.full((B,), T, dtype=torch.int64, device=device)
        return torch.clamp(counts, max=T).to(torch.int32)


class Block(nn.Module):
    """A block of ``BLOCKS``: ``forward(x (B, T', d), frames, compute_dtype,
    train=False, seed=None, attn_kernel=True)`` -> output, or with ``train``
    (output, new BatchNorm running mean, var); ``seed`` (the block's) keys
    its dropout. Its subsample's activation and what it serves go with it."""

    mesh = None
    subsample_act = nn.SiLU

    @staticmethod
    def serving_refusal(compute_dtype, device):
        """Why the block cannot serve in ``compute_dtype`` on ``device``, or None."""


class ConformerBlock(Block):
    def __init__(self, cfg):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_model * cfg.ff_mult
        self.ff1 = SwiGLUFeedForward(d, d_ff)
        self.norm_ff1 = TransposeGroupNorm(d)
        self.attn = MultiQueryAttention(d, cfg.n_heads, cfg.use_mqa)
        self.norm_attn = TransposeGroupNorm(d)
        self.conv = ConformerConvModule(d, cfg.conv_kernel_size)
        self.norm_conv = TransposeGroupNorm(d)  # declared by the reference, never run
        self.norm_conv.requires_grad_(False)  # so not trained (JAX has no such leaf)
        self.ff2 = SwiGLUFeedForward(d, d_ff)
        self.norm_ff2 = TransposeGroupNorm(d)
        self.final_norm = TransposeGroupNorm(d)
        self.masked_norm = cfg.masked_norm
        self.dropout = cfg.dropout

    def forward(self, x, frames, compute_dtype, train=False, seed=None, attn_kernel=True):
        """Over "seq" x holds this rank's frames and the mask all T'."""
        mask = frames.mask
        seq = axis_group(self.mesh, "seq")
        T = x.shape[1] if seq is None else mask.shape[1]
        t0, t1 = (0, T) if seq is None else seq_bounds(T, seq.size)[seq.index]
        span = (t0, t1, T)
        local = mask if (mask is None or seq is None) else mask[:, t0:t1]
        nm = local if (self.masked_norm and mask is not None) else None
        rate = self.dropout if (train and seed is not None) else 0.0
        data_rank = 0 if self.mesh is None else self.mesh.index("data")

        def site(i):
            return shard_seed(derive_seed(seed, i), data_rank) if rate > 0.0 else None

        x = x + 0.5 * self.ff1(self.norm_ff1(x, nm), compute_dtype, rate,
                               (site(SITE_FF1_GATE), site(SITE_FF1_OUT)), span)
        attn_seed = derive_seed(seed, SITE_ATTN) & 0xFFFFFFFF if rate > 0.0 else 0
        x = x + self.attn(self.norm_attn(x, nm), mask, compute_dtype, rate, attn_seed, span,
                          attn_kernel)
        conv = self.conv(x, compute_dtype, nm, train, span)
        if train:
            conv, stats = conv
        x = x + conv
        x = x + 0.5 * self.ff2(self.norm_ff2(x, nm), compute_dtype, rate,
                               (site(SITE_FF2_GATE), site(SITE_FF2_OUT)), span)
        out = self.final_norm(x, nm)
        return (out, *stats) if train else out


def layer_norm(norm, x):
    """LayerNorm of (B, T, C) over C: fp32 statistics, output in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class SwishFeedForward(nn.Module):
    """Linear(d, 4d) -> Swish -> Linear(4d, d)."""

    def __init__(self, d_model, d_ff):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, compute_dtype):
        return dense(self.linear2, dense(self.linear1, x, compute_dtype, act="silu"), compute_dtype)


class LayerNormConvModule(_ConvModule):
    """LayerNorm -> ``chain``, the depthwise padded as TensorFlow's SAME: k//2
    on both sides and an even kernel's first output dropped, leaving
    (k-1)//2 frames before and k//2 after."""

    def __init__(self, d_model, kernel_size):
        super().__init__(nn.LayerNorm(d_model), d_model, kernel_size, kernel_size // 2)

    def forward(self, x, mask, compute_dtype):
        return self.chain(layer_norm(self.norm, x), compute_dtype, mask)


class RelPosConformerBlock(Block):
    """Conformer (L)'s block (the module docstring's equations)."""

    subsample_act = nn.ReLU

    @staticmethod
    def serving_refusal(compute_dtype, device):
        # the relative-position attention kernel takes bf16 q, k, v and p
        if device.type == "cuda" and compute_dtype != torch.bfloat16:
            return ("a Conformer (L) checkpoint (block='conformer'); on CUDA it serves in "
                    "bfloat16 only")
        return None

    def __init__(self, cfg):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_model * cfg.ff_mult
        self.ff1 = SwishFeedForward(d, d_ff)
        self.norm_ff1 = nn.LayerNorm(d)
        self.attn = RelPositionMultiHeadAttention(d, cfg.n_heads)
        self.norm_attn = nn.LayerNorm(d)
        self.conv = LayerNormConvModule(d, cfg.conv_kernel_size)
        self.ff2 = SwishFeedForward(d, d_ff)
        self.norm_ff2 = nn.LayerNorm(d)
        self.final_norm = nn.LayerNorm(d)

    def forward(self, x, frames, compute_dtype, train=False, seed=None, attn_kernel=True):
        if self.mesh is not None:
            raise NotImplementedError("the Conformer (L) block runs on one process; it has "
                                      "no mesh axes")
        if train:
            raise NotImplementedError("training the Conformer (L) block is not implemented: "
                                      "its attention has no backward kernel")
        cd = compute_dtype
        lengths = frames.lengths
        x = x + 0.5 * self.ff1(layer_norm(self.norm_ff1, x), cd)
        x = x + self.attn(layer_norm(self.norm_attn, x), lengths, cd, attn_kernel)
        x = x + self.conv(x, frames.mask, cd)
        x = x + 0.5 * self.ff2(layer_norm(self.norm_ff2, x), cd)
        return layer_norm(self.final_norm, x)


# The blocks ``ModelConfig.block`` names.
BLOCKS = {"flagship": ConformerBlock, "conformer": RelPosConformerBlock}


# The subsample activations that ``bias_act`` applies as its tail; another
# runs after it.
FUSED_ACTS = {nn.ReLU: "relu", nn.SiLU: "silu"}


def _biased_act(h, bias, act, cd):
    """A convolution's (B, C, ...) output with its bias and ``act`` (through
    ``bias_act``'s tail where it has one)."""
    tail = FUSED_ACTS.get(type(act))
    h = bias_act(h, bias, cd, tail or "none", dim=1)
    return act(h) if tail is None else h


class Conv4Subsample(nn.Sequential):
    """Two stride-2 3x3 Conv2d of ``channels`` (padding 1), each with the
    block's ``subsample_act``: time and mel bins by 4. Its valid frames are
    ``lengths // 4``, the reference model's (not the convolutions' own
    ceil(ceil(L/2)/2))."""

    factor = 4

    def __init__(self, channels, act):
        super().__init__(nn.Conv2d(1, channels, 3, stride=2, padding=1), act(),
                         nn.Conv2d(channels, channels, 3, stride=2, padding=1), act())

    @staticmethod
    def out_bins(n_mels):
        return n_mels // 4

    @staticmethod
    def frames(lengths):
        """Valid output frames of (B,) input frame counts, in their dtype."""
        return lengths // 4

    def forward(self, x, cd, lengths=None):
        """(B, T, F) features -> (B, C, T', F') in ``cd`` (``lengths`` unused)."""
        h = x[:, None].to(cd)
        conv1, act1, conv2, act2 = self
        for conv, act in ((conv1, act1), (conv2, act2)):
            h = _biased_act(F.conv2d(h, conv.weight.to(cd), stride=2, padding=1), conv.bias,
                            act, cd)
        return h


class DwStriding8Subsample(nn.Sequential):
    """NeMo's ``dw_striding`` subsample by 8 (FastConformer, Rekesh et al.
    2023): Conv2d(1, C, 3x3, stride 2) -> act, then twice depthwise Conv2d(C,
    C, 3x3, stride 2, groups C) -> pointwise Conv2d(C, C, 1x1) -> act, all
    padded 1, so time and mel bins each go L -> (L - 1) // 2 + 1 three times
    (ceil(L/2)), which is also its valid frames' arithmetic. Parameters
    ``subsample.0`` (conv), ``.2``/``.3`` and ``.5``/``.6`` (depthwise and
    pointwise), as NeMo's ``conv`` sequence numbers them.

    With the rows' input frame counts, the frames past each stage's valid
    ones are zeroed before the next stage reads them, as the convolutions'
    own zero padding is for a file alone: a stride-2 kernel of 3 reads one
    frame past the valid ones, so without it the last valid frame, and
    through attention every frame, would depend on the bucket."""

    factor = 8

    def __init__(self, channels, act):
        def dw():
            return nn.Conv2d(channels, channels, 3, stride=2, padding=1, groups=channels)

        super().__init__(nn.Conv2d(1, channels, 3, stride=2, padding=1), act(),
                         dw(), nn.Conv2d(channels, channels, 1), act(),
                         dw(), nn.Conv2d(channels, channels, 1), act())

    @staticmethod
    def out_bins(n_mels):
        return DwStriding8Subsample.frames(n_mels)

    @staticmethod
    def frames(lengths):
        """Valid output frames of input frame counts (a (B,) tensor, in its
        dtype, or an int): each stride-2 convolution's (L - 1) // 2 + 1."""
        for _ in range(3):
            lengths = (lengths - 1) // 2 + 1
        return lengths

    def forward(self, x, cd, lengths=None):
        """(B, T, F) features and (B,) frame counts -> (B, C, T', F') in ``cd``."""
        conv, act = self[0], self[1]
        h = F.conv2d(x[:, None].to(cd), conv.weight.to(cd), stride=2, padding=1)
        h = _biased_act(h, conv.bias, act, cd)
        for i in (2, 5):
            if lengths is not None:
                lengths = (lengths - 1) // 2 + 1
                valid = torch.arange(h.shape[2], device=h.device)[None, :] < lengths[:, None]
                h = torch.where(valid[:, None, :, None], h, 0)
            dw, pw, act = self[i], self[i + 1], self[i + 2]
            h = F.conv2d(h, dw.weight.to(cd), stride=2, padding=1, groups=dw.groups)
            h = bias_act(h, dw.bias, cd, dim=1)
            h = _biased_act(F.conv2d(h, pw.weight.to(cd)), pw.bias, act, cd)
        return h


# The subsamples ``ModelConfig.subsample`` names.
SUBSAMPLES = {"conv4": Conv4Subsample, "dw_striding8": DwStriding8Subsample}


def dots_saveable(ctx, op, *args, **kwargs):
    """The ``--remat_policy dots`` checkpoint policy, JAX's
    ``dots_with_no_batch_dims_saveable`` (turkish_asr_tpu/train/trainer.py:63-77):
    save the products of the linear layers (``dense``: the SwiGLU FFNs'
    and q/k/v/out, ``jnp.dot`` in JAX) and recompute everything else:
    convolutions, norms, elementwise work and the attention core. The
    pointwise convolutions are matmuls here but convolutions in JAX, so
    the policy saves a matmul only inside ``dense``."""
    if op is torch.ops.aten.mm.default and in_dense_product():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class ConformerCTC(nn.Module):
    """The subsample ``SUBSAMPLES[cfg.subsample]`` names (its activations the
    block's ``subsample_act``), input projection, the blocks
    ``BLOCKS[cfg.block]`` names, linear CTC head. ``forward`` returns fp32
    logits."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.block_type = block = BLOCKS[cfg.block]
        kind = SUBSAMPLES[cfg.subsample]
        channels = cfg.subsample_channels or d
        self.subsample = kind(channels, block.subsample_act)
        self.input_proj = nn.Linear(channels * kind.out_bins(cfg.n_mels), d)
        self.blocks = nn.ModuleList(block(cfg) for _ in range(cfg.n_blocks))
        self.fc = nn.Linear(d, cfg.n_classes)

    def forward(self, x, input_lengths=None, compute_dtype=torch.float32, *, train=False,
                seed=None, remat=False, attn_kernel=True):
        """x (B, T, n_mels) features; input_lengths (B,) frame counts before
        subsampling. -> logits (B, T', n_classes) fp32.

        With ``train`` (JAX ``apply_model(train=True)``): BatchNorm uses
        batch statistics and the call returns (logits, new BatchNorm state,
        a list of (running mean, running var) per block, for
        ``commit_batch_norm``); dropout runs when ``seed`` (the step's) is
        given. ``remat`` recomputes each block in the backward
        (``torch.utils.checkpoint``, JAX's per-block ``jax.checkpoint``):
        ``"full"`` (or True) the whole block, ``"dots"`` all but the linear
        layers' products (``dots_saveable``).

        ``attn_kernel=False`` runs every block's attention core through its
        plain version (``ops.flash_attention_plain``, JAX's
        ``attn_kernel=None``): the bench's kernel-off runs pass it; the
        default is the kernel."""
        cd = compute_dtype
        sub = self.subsample
        with tracing.span("subsample", B=x.shape[0], T=x.shape[1], factor=sub.factor):
            h = sub(x, cd, input_lengths)  # (B, T, F) -> (B, C, T', F')
            B, C, Th, Fh = h.shape
            h = h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh)  # channel-major (C, F)
            mask = counts = None
            if input_lengths is not None:
                counts = sub.frames(input_lengths.to(torch.int64))
                mask = torch.arange(Th, device=h.device)[None, :] < counts[:, None]
            seq = axis_group(self.mesh, "seq")
            if seq is not None:  # this rank's frames; the blocks get the full mask
                bounds = seq_bounds(Th, seq.size)
                h = h[:, slice(*bounds[seq.index])]
                if mask is None:
                    mask = torch.ones((B, Th), dtype=torch.bool, device=h.device)
            h = dense(self.input_proj, h, cd)
        frames = Frames(mask, counts, B, Th, h.device)
        if not train:
            for block in self.blocks:
                h = block(h, frames, cd, attn_kernel=attn_kernel)
            return self._logits(h, cd, Th)
        if remat not in (False, None, True, "full", "dots"):
            raise ValueError(f"remat must be False, 'full' or 'dots', got {remat!r}")
        context = ({"context_fn": lambda: create_selective_checkpoint_contexts(dots_saveable)}
                   if remat == "dots" else {})
        bn_state = []
        for i, block in enumerate(self.blocks):
            block_seed = None if seed is None else derive_seed(seed, i)
            if remat:
                h, mean, var = torch.utils.checkpoint.checkpoint(
                    block, h, frames, cd, True, block_seed, attn_kernel, use_reentrant=False,
                    **context)
            else:
                h, mean, var = block(h, frames, cd, True, block_seed, attn_kernel)
            bn_state.append((mean, var))
        return self._logits(h, cd, Th), bn_state

    def _logits(self, h, cd, T):
        """fp32 logits of the blocks' output; over "seq" those of all T
        frames, gathered (the loss after them is replicated)."""
        logits = dense(self.fc, h, cd).float()
        seq = axis_group(self.mesh, "seq")
        if seq is None:
            return logits
        sizes = [b - a for a, b in seq_bounds(T, seq.size)]
        return all_gather(logits, 1, seq, sizes, replicated=True)

    @torch.no_grad()
    def commit_batch_norm(self, bn_state):
        """Write the running statistics a training forward returned."""
        for block, (mean, var) in zip(self.blocks, bn_state):
            block.conv.batch_norm.running_mean.copy_(mean)
            block.conv.batch_norm.running_var.copy_(var)


def count_params(model):
    """The elements of the model's trainable parameters: the JAX package's
    ``count_params`` of the same weights. The dead ``norm_conv`` GroupNorm is
    frozen and has no JAX leaf, so it is not counted."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def init_model(cfg: ModelConfig, generator=None):
    """A ConformerCTC with PyTorch's default uniform(+-1/sqrt(fan_in)) draws
    for every linear and conv weight and bias, as the JAX package's
    ``_linear_init``, ``_conv1d_init`` and ``_conv2d_init`` draw them, from
    ``generator``. Norms start at weight 1, bias 0; BatchNorm at mean 0,
    variance 1. The arithmetic does not read the module's train/eval flag:
    training is the ``train`` argument of ``forward``. The ``conformer``
    block's ``pos_bias_u`` and ``pos_bias_v`` are drawn uniform in
    +-1/sqrt(head size); its ``linear_pos`` has no bias."""
    model = ConformerCTC(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # 1 / sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, RelPositionMultiHeadAttention):
                bound = 1.0 / math.sqrt(mod.d_head)
                mod.pos_bias_u.uniform_(-bound, bound, generator=generator)
                mod.pos_bias_v.uniform_(-bound, bound, generator=generator)
    return model
