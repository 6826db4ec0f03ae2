"""Plain reference of Conformer (L) with a CTC head, for the tests: the
forward in plain ``torch``, float32 with TF32 off, over a state dict with
the port's names. It imports nothing of the port and nothing of JAX.

Gulati et al. 2020 (Conformer, arXiv:2005.08100), every module pre-norm:

    x1 = x + FFN(x) / 2         FFN = LayerNorm, Linear(d, 4d), Swish, Linear(4d, d)
    x2 = x1 + MHSA(LayerNorm(x1))
    x3 = x2 + Conv(x2)          Conv = LayerNorm, pointwise(2d), GLU, depthwise(k),
                                       BatchNorm, Swish, pointwise(d)
    y  = LayerNorm(x3 + FFN(x3) / 2)

MHSA is Transformer-XL's relative-position attention (Dai et al. 2019,
arXiv:1901.02860, sec. 3.3): for head h,
S[i, j] = ((q_i + u_h) . k_j + (q_i + v_h) . p_{i-j}) / sqrt(d_head), with
p_r = W_pos R_r and R_r = [sin(r w_m) | cos(r w_m)], w_m = 10000^(-2m/d).
The relative term is materialised: (q + v) . p against all 2T-1
distances (T-1 down to -(T-1)), then ESPnet's pad-view-slice rel-shift.

Departures from the paper, or where it says nothing:
- a linear CTC head in place of the LSTM transducer decoder;
- the subsample's two stride-2 3x3 convolutions take ReLU and padding 1;
- u and v are learned per layer;
- padded frames are zeroed before the depthwise convolution (the masked
  depthwise input, as NeMo's Conformer);
- the depthwise convolution pads (k-1)//2 frames before and k//2 after
  (TensorFlow's SAME: 15 and 16 for k = 32).
"""

import math

import torch
import torch.nn.functional as F


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def positions(T, d):
    """(2T-1, d) float32 sinusoids of the distances T-1 down to -(T-1)."""
    r = torch.arange(T - 1, -T, -1, dtype=torch.float64)
    omega = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    angle = torch.outer(r, omega)
    return torch.cat([angle.sin(), angle.cos()], dim=-1).float()


def rel_shift(x):
    """ESPnet's pad-view-slice: (B, H, T, 2T-1) against the distances T-1
    ... -(T-1) -> (B, H, T, T), column j of row i at distance i - j."""
    B, H, T, P = x.shape
    padded = torch.cat([x.new_zeros((B, H, T, 1)), x], dim=-1).view(B, H, P + 1, T)
    return padded[:, :, 1:].reshape(B, H, T, P)[:, :, :, :T]


def relpos_attention(q, k, v, p, u, vb, mask):
    """q, k, v (B, H, T, dh); p (H, 2T-1, dh); u, vb (H, dh); mask (B, T)
    -> (B, H, T, dh)."""
    dh = q.shape[-1]
    content = (q + u[None, :, None]) @ k.transpose(-1, -2)
    position = rel_shift((q + vb[None, :, None]) @ p.transpose(-1, -2))
    scores = (content + position) / math.sqrt(dh)
    scores = scores + (mask.float()[:, None, None, :] - 1.0) * 1e9
    return torch.softmax(scores, dim=-1) @ v


def forward(sd, cfg, feats, frame_lengths):
    """(B, T, n_mels) features, (B,) frame counts -> (B, T', V) float32
    logits. ``cfg``: n_heads, n_blocks, conv_kernel_size."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward({k: v.float() if v.is_floating_point() else v for k, v in sd.items()},
                        cfg, feats.float(), frame_lengths)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _helpers(w):
    def lin(name, x):
        y = x @ w[name + ".weight"].t()
        return y + w[name + ".bias"] if name + ".bias" in w else y

    def ln(name, x):
        return layer_norm(x, w[name + ".weight"], w[name + ".bias"])

    def ff(name, x):
        return lin(name + ".linear2", F.silu(lin(name + ".linear1", x)))

    return lin, ln, ff


def _forward(w, cfg, feats, frame_lengths):
    lin = _helpers(w)[0]
    h = feats[:, None]
    for i in (0, 2):
        h = F.relu(F.conv2d(h, w[f"subsample.{i}.weight"], w[f"subsample.{i}.bias"],
                            stride=2, padding=1))
    B, C, T, Fh = h.shape
    h = lin("input_proj", h.permute(0, 2, 1, 3).reshape(B, T, C * Fh))
    mask = torch.arange(T)[None, :] < (frame_lengths // 4)[:, None]
    return lin("fc", blocks(w, cfg, h, mask))


def blocks(w, cfg, h, mask):
    """The blocks of float32 weights ``w`` over (B, T', d) ``h`` with the
    (B, T') valid-frame ``mask``. ``cfg``: n_heads, n_blocks,
    conv_kernel_size."""
    lin, ln, ff = _helpers(w)
    H, k = cfg["n_heads"], cfg["conv_kernel_size"]
    B, T, d = h.shape
    dh = d // H
    pos = positions(T, d)
    for i in range(cfg["n_blocks"]):
        pre = f"blocks.{i}"
        h = h + 0.5 * ff(pre + ".ff1", ln(pre + ".norm_ff1", h))
        x = ln(pre + ".norm_attn", h)
        q, kk, v = (lin(f"{pre}.attn.linear_{n}", x).reshape(B, T, H, dh).transpose(1, 2)
                    for n in ("q", "k", "v"))
        p = lin(pre + ".attn.linear_pos", pos).reshape(2 * T - 1, H, dh).transpose(0, 1)
        ctx = relpos_attention(q, kk, v, p, w[pre + ".attn.pos_bias_u"],
                               w[pre + ".attn.pos_bias_v"], mask)
        h = h + lin(pre + ".attn.linear_out", ctx.transpose(1, 2).reshape(B, T, d))
        c = pre + ".conv"
        x = ln(c + ".norm", h)
        x = x @ w[c + ".pointwise_conv1.weight"][:, :, 0].t() + w[c + ".pointwise_conv1.bias"]
        x = x[..., :d] * torch.sigmoid(x[..., d:]) * mask.float()[:, :, None]
        x = F.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)),
                     w[c + ".depthwise_conv.weight"], w[c + ".depthwise_conv.bias"],
                     groups=d).transpose(1, 2)
        bn = c + ".batch_norm"
        x = ((x - w[bn + ".running_mean"]) / torch.sqrt(w[bn + ".running_var"] + 1e-5)
             * w[bn + ".weight"] + w[bn + ".bias"])
        x = F.silu(x) @ w[c + ".pointwise_conv2.weight"][:, :, 0].t()
        h = h + x + w[c + ".pointwise_conv2.bias"]
        h = h + 0.5 * ff(pre + ".ff2", ln(pre + ".norm_ff2", h))
        h = ln(pre + ".final_norm", h)
    return h
