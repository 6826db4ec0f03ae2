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
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from turkish_asr_torch.models.attention import MultiQueryAttention, dense, in_dense_product


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


def group_norm(norm, x, mask=None, eps=1e-5):
    """GroupNorm on (B, T, C) with fp32 statistics per (sample, group)."""
    B, T, C = x.shape
    G = norm.num_groups
    cg = C // G
    xf = x.float()

    def group_sum(per_channel):  # (B, C) -> per-group sums broadcast to (B, C)
        return per_channel.reshape(B, G, cg).sum(-1).repeat_interleave(cg, dim=-1)

    if mask is None:
        mean = group_sum(xf.sum(dim=1)) / (T * cg)
        d = xf - mean[:, None, :]
        var = group_sum((d * d).sum(dim=1)) / (T * cg)
    else:
        m = mask.float()[:, :, None]
        denom = torch.clamp(m.sum(dim=1) * cg, min=1.0)
        mean = group_sum((xf * m).sum(dim=1)) / denom
        d = xf - mean[:, None, :]
        var = group_sum((d * d * m).sum(dim=1)) / denom
    xn = d * torch.rsqrt(var + eps)[:, None, :]
    return (xn * norm.weight + norm.bias).to(x.dtype)


class TransposeGroupNorm(nn.Module):
    """GroupNorm over the channels of a (B, T, C) input (reference name)."""

    def __init__(self, d_model):
        super().__init__()
        self.norm = nn.GroupNorm(groupnorm_groups(d_model), d_model)

    def forward(self, x, mask=None):
        return group_norm(self.norm, x, mask)


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


def dropout(x, rate, seed):
    """JAX ``_dropout``: keep with probability 1 - rate, scale kept values
    by 1/(1 - rate) in x's dtype. The mask comes from a generator seeded
    with ``seed`` on x's device; no dropout for rate 0 or seed None."""
    if rate <= 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class SwiGLUFeedForward(nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.linear1 = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, compute_dtype, rate=0.0, seeds=(None, None)):
        """``seeds``: the dropout seeds after the gate product and after
        the output projection."""
        h = dense(self.linear1, x, compute_dtype)
        h1, h2 = h.chunk(2, dim=-1)
        h = dropout(F.silu(h1) * h2, rate, seeds[0])
        return dropout(dense(self.linear2, h, compute_dtype), rate, seeds[1])


def _conv_out(out, bias, compute_dtype):
    """Conv product in the compute dtype -> fp32 bias add -> compute dtype."""
    return (out.float() + bias.float()).to(compute_dtype)


def batch_norm_train(bn, x, mask=None, momentum=0.1):
    """BatchNorm over (B, T, C) with batch statistics, as
    torch.nn.BatchNorm1d trains: the biased variance normalizes, the
    unbiased variance updates the running estimate. With ``mask`` (B, T)
    the statistics span the valid frames only.

    Returns (y in x's dtype, (new running mean, new running var)); the
    module's buffers are not touched."""
    xf = x.float()
    if mask is not None:
        m = mask.float()[:, :, None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=(0, 1)) / n
        var = torch.where(m > 0, (xf - mean) ** 2, 0.0).sum(dim=(0, 1)) / n
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

    def __init__(self, d_model, kernel_size):
        super().__init__()
        self.norm = TransposeGroupNorm(d_model)
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=d_model)
        self.batch_norm = nn.BatchNorm1d(d_model)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)

    def forward(self, x, compute_dtype, norm_mask=None, train=False):
        """-> output, or (output, new BatchNorm running stats) with ``train``."""
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
        h = F.conv1d(h.transpose(1, 2).to(cd), dw.weight.to(cd), padding=dw.padding,
                     groups=dw.groups).transpose(1, 2)
        h = _conv_out(h, dw.bias, cd)
        bn = self.batch_norm
        if train:
            h, stats = batch_norm_train(bn, h, norm_mask)
        else:
            hn = (h.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
            h = (hn * bn.weight + bn.bias).to(cd)
        h = F.silu(h)
        w2 = self.pointwise_conv2.weight[:, :, 0].to(cd)
        out = _conv_out(torch.matmul(h, w2.t()), self.pointwise_conv2.bias, cd)
        return (out, stats) if train else out


class ConformerBlock(nn.Module):
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

    def forward(self, x, mask, compute_dtype, train=False, seed=None):
        """-> output, or (output, new BatchNorm running mean, var) with
        ``train``; ``seed`` (the block's) keys its dropout masks."""
        nm = mask if (self.masked_norm and mask is not None) else None
        rate = self.dropout if (train and seed is not None) else 0.0

        def site(i):
            return derive_seed(seed, i) if rate > 0.0 else None

        x = x + 0.5 * self.ff1(self.norm_ff1(x, nm), compute_dtype, rate,
                               (site(SITE_FF1_GATE), site(SITE_FF1_OUT)))
        attn_seed = site(SITE_ATTN)
        x = x + self.attn(self.norm_attn(x, nm), mask, compute_dtype, rate,
                          0 if attn_seed is None else attn_seed & 0xFFFFFFFF)
        conv = self.conv(x, compute_dtype, nm, train)
        if train:
            conv, stats = conv
        x = x + conv
        x = x + 0.5 * self.ff2(self.norm_ff2(x, nm), compute_dtype, rate,
                               (site(SITE_FF2_GATE), site(SITE_FF2_OUT)))
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
                seed=None, remat=False):
        """x (B, T, n_mels) features; input_lengths (B,) frame counts before
        subsampling. -> logits (B, T', n_classes) fp32.

        With ``train`` (JAX ``apply_model(train=True)``): BatchNorm uses
        batch statistics and the call returns (logits, new BatchNorm state,
        a list of (running mean, running var) per block, for
        ``commit_batch_norm``); dropout runs when ``seed`` (the step's) is
        given. ``remat`` recomputes each block in the backward
        (``torch.utils.checkpoint``, JAX's per-block ``jax.checkpoint``):
        ``"full"`` (or True) the whole block, ``"dots"`` all but the linear
        layers' products (``dots_saveable``)."""
        cd = compute_dtype
        h = x[:, None].to(cd)  # (B, 1, T, F)
        for conv in (self.subsample[0], self.subsample[2]):
            h = F.conv2d(h, conv.weight.to(cd), stride=2, padding=1)
            h = F.silu((h.float() + conv.bias.float()[:, None, None]).to(cd))
        B, C, Th, Fh = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh)  # channel-major (C, F)
        h = dense(self.input_proj, h, cd)
        mask = None
        if input_lengths is not None:
            sub = input_lengths.to(torch.int64) // 4
            mask = torch.arange(Th, device=h.device)[None, :] < sub[:, None]
        if not train:
            for block in self.blocks:
                h = block(h, mask, cd)
            return dense(self.fc, h, cd).float()
        if remat not in (False, None, True, "full", "dots"):
            raise ValueError(f"remat must be False, 'full' or 'dots', got {remat!r}")
        context = {"context_fn": dots_context} if remat == "dots" else {}
        bn_state = []
        for i, block in enumerate(self.blocks):
            block_seed = None if seed is None else derive_seed(seed, i)
            if remat:
                h, mean, var = torch.utils.checkpoint.checkpoint(
                    block, h, mask, cd, True, block_seed, use_reentrant=False, **context)
            else:
                h, mean, var = block(h, mask, cd, True, block_seed)
            bn_state.append((mean, var))
        return dense(self.fc, h, cd).float(), bn_state

    @torch.no_grad()
    def commit_batch_norm(self, bn_state):
        """Write the running statistics a training forward returned."""
        for block, (mean, var) in zip(self.blocks, bn_state):
            block.conv.batch_norm.running_mean.copy_(mean)
            block.conv.batch_norm.running_var.copy_(var)


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
