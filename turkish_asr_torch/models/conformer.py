"""Conformer-CTC encoder in PyTorch (inference).

Counterpart of turkish_asr_tpu/models/conformer.py. The module tree and
parameter names are those of the reference ``TurkishASRModel``, i.e. the
keys turkish_asr_tpu/utils/torch_export.py writes, so a ``.pt`` from
``export_model.py --format torch`` loads with ``strict=True`` (the dead
``norm_conv`` GroupNorm included). The torch modules hold the parameters;
the arithmetic is written out so its cast points follow the JAX package:

- GroupNorm: fp32 statistics over (time, channels of the group), output in
  the input dtype; padding leaks into the statistics unless ``masked_norm``.
- BatchNorm: running statistics (eval).
- dense layers and convolutions: the product in the compute dtype, the
  bias added in fp32, then cast back.
- the padding mask is ``arange(T') < input_lengths // 4``; the subsample
  output flattens channel-major, (C, F).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from turkish_asr_torch.models.attention import MultiQueryAttention, dense


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


class SwiGLUFeedForward(nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.linear1 = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, compute_dtype):
        h = dense(self.linear1, x, compute_dtype)
        h1, h2 = h.chunk(2, dim=-1)
        return dense(self.linear2, F.silu(h1) * h2, compute_dtype)


def _conv_out(out, bias, compute_dtype):
    """Conv product in the compute dtype -> fp32 bias add -> compute dtype."""
    return (out.float() + bias.float()).to(compute_dtype)


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

    def forward(self, x, compute_dtype, norm_mask=None):
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
        hn = (h.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        h = F.silu((hn * bn.weight + bn.bias).to(cd))
        w2 = self.pointwise_conv2.weight[:, :, 0].to(cd)
        return _conv_out(torch.matmul(h, w2.t()), self.pointwise_conv2.bias, cd)


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
        self.ff2 = SwiGLUFeedForward(d, d_ff)
        self.norm_ff2 = TransposeGroupNorm(d)
        self.final_norm = TransposeGroupNorm(d)
        self.masked_norm = cfg.masked_norm

    def forward(self, x, mask, compute_dtype):
        nm = mask if (self.masked_norm and mask is not None) else None
        x = x + 0.5 * self.ff1(self.norm_ff1(x, nm), compute_dtype)
        x = x + self.attn(self.norm_attn(x, nm), mask, compute_dtype)
        x = x + self.conv(x, compute_dtype, nm)
        x = x + 0.5 * self.ff2(self.norm_ff2(x, nm), compute_dtype)
        return self.final_norm(x, nm)


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

    def forward(self, x, input_lengths=None, compute_dtype=torch.float32):
        """x (B, T, n_mels) features; input_lengths (B,) frame counts before
        subsampling. -> logits (B, T', n_classes) fp32."""
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
        for block in self.blocks:
            h = block(h, mask, cd)
        return dense(self.fc, h, cd).float()


def init_model(cfg: ModelConfig, generator=None):
    """A ConformerCTC with PyTorch's default uniform(+-1/sqrt(fan_in)) draws
    for every linear and conv weight and bias, as the JAX package's
    ``_linear_init``, ``_conv1d_init`` and ``_conv2d_init`` draw them, from
    ``generator``. Norms start at weight 1, bias 0; BatchNorm at mean 0,
    variance 1."""
    model = ConformerCTC(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # 1 / sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
    return model.eval()
