"""The plain reference of Conformer (L) with a CTC head: model and logits,
in plain PyTorch, as served (no dropout, BatchNorm's running statistics).

It imports nothing of the program and takes nothing the program made: the
weights come from ``asr_bench/conformer_l_weights.py``, the front end and
the rounding of products (``Precision``) from ``conformer_ctc.py``. It
follows Gulati et al. 2020 (Conformer, arXiv:2005.08100, Table 1:
Conformer (L): 17 blocks of d 512, 8 heads, convolution kernel 32), every
module pre-norm:

    x1 = x + FFN(x) / 2         FFN = LayerNorm, Linear(d, 4d), Swish, Linear(4d, d)
    x2 = x1 + MHSA(LayerNorm(x1))
    x3 = x2 + Conv(x2)          Conv = LayerNorm, pointwise(2d), GLU, depthwise(k),
                                       BatchNorm, Swish, pointwise(d)
    y  = LayerNorm(x3 + FFN(x3) / 2)

MHSA is Transformer-XL's relative-position attention (Dai et al. 2019,
arXiv:1901.02860, sec. 3.3): for head h,
S[i, j] = ((q_i + u_h) . k_j + (q_i + v_h) . p_{i-j}) / sqrt(64), with
p_r = W_pos R_r and R_r = [sin(r w_m) | cos(r w_m)], w_m = 10000^(-2m/d).
The position term is computed against all 2T-1 distances (T-1 down to
-(T-1)) and moved to (i, j) by the pad-view-slice rel-shift (ESPnet).

Where it departs from the paper, or the paper says nothing:
- a linear CTC head over the vocabulary in place of the one-layer LSTM
  transducer decoder;
- the subsample's two stride-2 3x3 convolutions take ReLU and padding 1,
  then a linear projection to d (no input scaling);
- u and v are learned per layer;
- padded frames are zeroed before the depthwise convolution (NeMo's
  Conformer does so);
- the depthwise convolution pads as TensorFlow's ``SAME`` (the paper's
  Lingvo): (k-1)//2 frames before, k//2 after (15 and 16 for k = 32).

Precision as ``conformer_ctc.py``: ``"fp32"`` every product in float32
with TF32 off; ``"fp8"`` the control, each product's operands rounded to
float8 e4m3.
"""

import math

import torch
import torch.nn.functional as F

from asr_bench.reference.conformer_ctc import MASK_SHIFT, Precision, bucket, features, no_tf32


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def positions(T, d, device):
    """(2T-1, d) float32 sinusoids of the distances T-1 down to -(T-1)."""
    r = torch.arange(T - 1, -T, -1, dtype=torch.float64)
    omega = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    angle = torch.outer(r, omega)
    return torch.cat([angle.sin(), angle.cos()], dim=-1).float().to(device)


def rel_shift(x):
    """(B, H, T, 2T-1) scores against the distances T-1 ... -(T-1) ->
    (B, H, T, T) with column j of row i the distance i - j (ESPnet's
    pad-view-slice)."""
    B, H, T, P = x.shape
    padded = torch.cat([x.new_zeros((B, H, T, 1)), x], dim=-1)
    padded = padded.view(B, H, P + 1, T)
    return padded[:, :, 1:].reshape(B, H, T, P)[:, :, :, :T]


class Reference:
    """The model's function over a state dict ``sd`` (the program's names)
    and ``cfg`` (a dict of the configuration file)."""

    def __init__(self, sd, cfg, precision="fp32"):
        self.sd = sd
        self.cfg = cfg
        self.p = Precision(precision)

    def w(self, name):
        return self.sd[name].float()

    def lin(self, prefix, x):
        bias = prefix + ".bias"
        return self.p.linear(x, self.w(prefix + ".weight"),
                             self.w(bias) if bias in self.sd else None)

    def ln(self, prefix, x):
        return layer_norm(x, self.w(prefix + ".weight"), self.w(prefix + ".bias"))

    def ff(self, prefix, x):
        return self.lin(prefix + ".linear2", F.silu(self.lin(prefix + ".linear1", x)))

    def attn(self, prefix, x, mask):
        B, T, D = x.shape
        H = self.cfg["n_heads"]
        dh = D // H
        q, k, v = (self.lin(f"{prefix}.linear_{n}", x).reshape(B, T, H, dh).transpose(1, 2)
                   for n in ("q", "k", "v"))
        p = self.lin(prefix + ".linear_pos", positions(T, D, x.device))
        p = p.reshape(2 * T - 1, H, dh).transpose(0, 1)                    # (H, 2T-1, dh)
        u = self.w(prefix + ".pos_bias_u")[None, :, None]
        vb = self.w(prefix + ".pos_bias_v")[None, :, None]
        content = self.p.bmm(q + u, k.transpose(-1, -2))
        position = rel_shift(self.p.bmm(q + vb, p.transpose(-1, -2)))
        scores = (content + position) / math.sqrt(dh)
        scores = scores + (mask.float()[:, None, None, :] - 1.0) * MASK_SHIFT
        ctx = self.p.bmm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, T, D)
        return self.lin(prefix + ".linear_out", ctx)

    def conv(self, prefix, x, mask):
        d = x.shape[-1]
        k = self.cfg["conv_kernel_size"]
        h = self.ln(prefix + ".norm", x)
        h = self.p.linear(h, self.w(prefix + ".pointwise_conv1.weight")[:, :, 0],
                          self.w(prefix + ".pointwise_conv1.bias"))
        h = h[..., :d] * torch.sigmoid(h[..., d:])
        h = h * mask.float()[:, :, None]
        h = F.pad(h.transpose(1, 2), ((k - 1) // 2, k // 2))
        h = self.p.conv1d(h, self.w(prefix + ".depthwise_conv.weight"),
                          self.w(prefix + ".depthwise_conv.bias"), groups=d).transpose(1, 2)
        bn = prefix + ".batch_norm"
        mean, var = self.w(bn + ".running_mean"), self.w(bn + ".running_var")
        h = (h - mean) / torch.sqrt(var + 1e-5) * self.w(bn + ".weight") + self.w(bn + ".bias")
        h = F.silu(h)
        return self.p.linear(h, self.w(prefix + ".pointwise_conv2.weight")[:, :, 0],
                             self.w(prefix + ".pointwise_conv2.bias"))

    def forward(self, feats, frame_lengths):
        """(B, T, n_mels) features and (B,) frame counts -> (B, T', V)
        float32 logits."""
        h = feats.float()[:, None]
        for i in (0, 2):
            h = F.relu(self.p.conv2d(h, self.w(f"subsample.{i}.weight"),
                                     self.w(f"subsample.{i}.bias"), stride=2, padding=1))
        B, C, Th, Fh = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh)
        mask = torch.arange(Th, device=h.device)[None, :] < (frame_lengths // 4)[:, None]
        h = self.lin("input_proj", h)
        for i in range(self.cfg["n_blocks"]):
            pre = f"blocks.{i}"
            h = h + 0.5 * self.ff(pre + ".ff1", self.ln(pre + ".norm_ff1", h))
            h = h + self.attn(pre + ".attn", self.ln(pre + ".norm_attn", h), mask)
            h = h + self.conv(pre + ".conv", h, mask)
            h = h + 0.5 * self.ff(pre + ".ff2", self.ln(pre + ".norm_ff2", h))
            h = self.ln(pre + ".final_norm", h)
        return self.lin("fc", h)


def logits_of(sd, cfg, waves, precision="fp32", device="cpu", rows=8):
    """Each row of samples, at the bucket its length falls in, -> a list of
    (valid frames, V) float32 logits. Up to ``rows`` rows of one bucket
    run together."""
    out = [None] * len(waves)
    by_bucket = {}
    for i, w in enumerate(waves):
        by_bucket.setdefault(bucket(len(w)), []).append(i)
    ref = Reference(sd, cfg, precision)
    with torch.no_grad(), no_tf32():
        for S, idx in sorted(by_bucket.items()):
            for j in range(0, len(idx), rows):
                part = idx[j:j + rows]
                feats, lengths = features([waves[i] for i in part], S, cfg["n_mels"], device)
                logits = ref.forward(feats, lengths)
                for r, i in enumerate(part):
                    out[i] = logits[r, :int(lengths[r]) // 4].float().cpu()
    return out
