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
  bias added in fp32, then cast back.
- the padding mask is ``arange(T') < input_lengths // 4``; the subsample
  output flattens channel-major, (C, F).
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
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from turkish_asr_torch.models.attention import MultiQueryAttention, dense, in_dense_product
from turkish_asr_torch.parallel.collectives import all_gather, all_reduce, copy_to, halo
from turkish_asr_torch.parallel.mesh import axis_group, seq_bounds, shard_seed


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


def _conv_out(out, bias, compute_dtype):
    """Conv product in the compute dtype -> fp32 bias add -> compute dtype."""
    return (out.float() + bias.float()).to(compute_dtype)


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


class ConformerConvModule(nn.Module):
    """GroupNorm -> pointwise(2d) -> GLU -> depthwise(k) -> BN -> SiLU -> pointwise."""

    mesh = None

    def __init__(self, d_model, kernel_size):
        super().__init__()
        self.norm = TransposeGroupNorm(d_model)
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=d_model)
        self.batch_norm = nn.BatchNorm1d(d_model)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)

    def forward(self, x, compute_dtype, norm_mask=None, train=False, span=None):
        """-> output, or (output, new BatchNorm running stats) with ``train``.
        Over "seq" (``span``: this rank's frames t0:t1 of T) the depthwise
        convolution takes (k-1)/2 frames of halo from the ranks beside."""
        d = x.shape[-1]
        cd = compute_dtype
        h = self.norm(x, norm_mask)
        if norm_mask is not None:
            h = torch.where(norm_mask[:, :, None], h, 0)
        # Pointwise convs are (B, T, C) products with the (O, I, 1) kernel.
        w1 = self.pointwise_conv1.weight[:, :, 0].to(cd)
        h = _conv_out(torch.matmul(h.to(cd), w1.t()), self.pointwise_conv1.bias, cd)
        h = h[..., :d] * torch.sigmoid(h[..., d:])  # GLU over channels
        if norm_mask is not None:
            h = torch.where(norm_mask[:, :, None], h, 0)  # bias leaks via pw1
        dw = self.depthwise_conv
        seq = axis_group(self.mesh, "seq")
        if seq is None:
            h = F.conv1d(h.transpose(1, 2).to(cd), dw.weight.to(cd), padding=dw.padding,
                         groups=dw.groups)
        else:
            sizes = [b - a for a, b in seq_bounds(span[2], seq.size)]
            h = halo(h.to(cd), dw.padding[0], seq, sizes)
            h = F.conv1d(h.transpose(1, 2), dw.weight.to(cd), groups=dw.groups)
        h = _conv_out(h.transpose(1, 2), dw.bias, cd)
        bn = self.batch_norm
        if train:
            h, stats = batch_norm_train(bn, h, norm_mask,
                                        group=axis_group(self.mesh, "data", "seq"))
        else:
            hn = (h.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
            h = (hn * bn.weight + bn.bias).to(cd)
        h = F.silu(h)
        w2 = self.pointwise_conv2.weight[:, :, 0].to(cd)
        out = _conv_out(torch.matmul(h, w2.t()), self.pointwise_conv2.bias, cd)
        return (out, stats) if train else out


class ConformerBlock(nn.Module):
    mesh = None

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

    def forward(self, x, mask, compute_dtype, train=False, seed=None, attn_kernel=True):
        """-> output, or (output, new BatchNorm running mean, var) with
        ``train``; ``seed`` (the block's) keys its dropout masks. Over
        "seq" x holds this rank's frames and ``mask`` all T' frames.
        ``attn_kernel=False``: the attention core's plain version."""
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


def dots_context():
    """``torch.utils.checkpoint``'s ``context_fn`` for ``dots_saveable``."""
    return create_selective_checkpoint_contexts(dots_saveable)


class ConformerCTC(nn.Module):
    """Two stride-2 Conv2d + SiLU subsample, input projection, Conformer
    blocks, linear CTC head. ``forward`` returns fp32 logits."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.subsample = nn.Sequential(
            nn.Conv2d(1, d, 3, stride=2, padding=1), nn.SiLU(),
            nn.Conv2d(d, d, 3, stride=2, padding=1), nn.SiLU())
        self.input_proj = nn.Linear(d * (cfg.n_mels // 4), d)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.n_blocks))
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
        h = x[:, None].to(cd)  # (B, 1, T, F)
        for conv in (self.subsample[0], self.subsample[2]):
            h = F.conv2d(h, conv.weight.to(cd), stride=2, padding=1)
            h = F.silu((h.float() + conv.bias.float()[:, None, None]).to(cd))
        B, C, Th, Fh = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh)  # channel-major (C, F)
        mask = None
        if input_lengths is not None:
            sub = input_lengths.to(torch.int64) // 4
            mask = torch.arange(Th, device=h.device)[None, :] < sub[:, None]
        seq = axis_group(self.mesh, "seq")
        if seq is not None:  # this rank's frames; the blocks get the full mask
            bounds = seq_bounds(Th, seq.size)
            h = h[:, slice(*bounds[seq.index])]
            if mask is None:
                mask = torch.ones((B, Th), dtype=torch.bool, device=h.device)
        h = dense(self.input_proj, h, cd)
        if not train:
            for block in self.blocks:
                h = block(h, mask, cd, attn_kernel=attn_kernel)
            return self._logits(h, cd, Th)
        if remat not in (False, None, True, "full", "dots"):
            raise ValueError(f"remat must be False, 'full' or 'dots', got {remat!r}")
        context = {"context_fn": dots_context} if remat == "dots" else {}
        bn_state = []
        for i, block in enumerate(self.blocks):
            block_seed = None if seed is None else derive_seed(seed, i)
            if remat:
                h, mean, var = torch.utils.checkpoint.checkpoint(
                    block, h, mask, cd, True, block_seed, attn_kernel, use_reentrant=False,
                    **context)
            else:
                h, mean, var = block(h, mask, cd, True, block_seed, attn_kernel)
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
    training is the ``train`` argument of ``forward``."""
    model = ConformerCTC(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # 1 / sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
    return model
