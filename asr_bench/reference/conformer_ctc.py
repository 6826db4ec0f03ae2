"""The plain reference of the benchmark's Conformer-CTC: front end and
model, in plain PyTorch, as served (no dropout, BatchNorm's running
statistics).

It imports nothing of the program and takes nothing the program made: the
weights come from ``asr_bench/weights.py`` and the audio from the
benchmark's own WAV bytes. It follows the published description of the
reference model (Eminkorkut/Turkish-ASR-Model, ``model/conformer.py``): a
two-conv stride-4 subsample, an input projection, macaron Conformer blocks
(half-step SwiGLU feed-forwards, multi-query self-attention with RoPE, a
convolution module with GLU, a depthwise convolution and BatchNorm,
GroupNorm before each part and after the block) and a linear CTC head.

Precision: ``"fp32"`` computes every product in float32 with TF32 off
(``no_tf32``); the front end runs in float64. ``"fp8"`` is the control: the
two operands of every product (matmuls and convolutions) are rounded to
float8 e4m3 with a per-tensor scale before the float32 product, the step
below the bfloat16 that the configuration states.
"""

import contextlib
import io
import math
import wave

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
N_FFT, HOP = 400, 160
WAVEFORM_BUCKETS = tuple(int(SR * s) for s in (1, 2, 4, 6, 8, 12, 16, 24, 32))
MASK_SHIFT = 1e9


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def bucket(n, buckets=WAVEFORM_BUCKETS):
    """The smallest bucket that holds ``n``, or the largest."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def decode_wav(blob):
    """16-bit PCM mono WAV bytes -> float32 samples in [-1, 1)."""
    with wave.open(io.BytesIO(blob)) as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError("the benchmark writes 16-bit mono WAV only")
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32768.0


# ---------------------------------------------------------------------------
# front end


def mel_filterbank(n_freqs=N_FFT // 2 + 1, n_mels=80, f_max=SR / 2):
    """(n_freqs, n_mels) HTK triangular filters, unnormalized, float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    freqs = np.linspace(0.0, SR / 2, n_freqs)
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), n_mels + 2)
    pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def log_mel(x, n_mels=80, top_db=80.0):
    """(S,) samples -> (1 + S // 160, n_mels) CMVN log-mel, float64: a
    centred, reflect-padded STFT with a periodic Hann window, power, HTK
    mel, dB clamped ``top_db`` below the maximum, then per-utterance mean
    and unbiased standard deviation."""
    x = torch.as_tensor(x, dtype=torch.float64)
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, N_FFT, window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                      # (bins, T)
    fb = torch.from_numpy(mel_filterbank(n_mels=n_mels)).to(x.device)
    db = 10.0 * torch.log10(torch.clamp(power.T @ fb, min=1e-10))
    db = torch.maximum(db, db.max() - top_db)
    mean = db.mean(dim=0, keepdim=True)
    std = db.std(dim=0, keepdim=True, unbiased=True)
    return (db - mean) / (std + 1e-8)


def features(waves, S, n_mels=80, device="cpu"):
    """Rows of samples, each at its own length, -> ((B, 1 + S // 160,
    n_mels) float64 features zero past each row's frames, (B,) frame
    counts)."""
    T = 1 + S // HOP
    out = torch.zeros((len(waves), T, n_mels), dtype=torch.float64, device=device)
    lengths = []
    for i, w in enumerate(waves):
        f = log_mel(torch.as_tensor(w, device=device), n_mels)
        out[i, :f.shape[0]] = f
        lengths.append(f.shape[0])
    return out, torch.tensor(lengths, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# precision


def quant_fp8(t):
    """Round to float8 e4m3 under a per-tensor scale (max |t| -> 448)."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class Precision:
    """The rounding of a product's operands."""

    def __init__(self, name):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, got {name!r}")
        self.name = name

    def operand(self, t):
        t = t.float()
        return quant_fp8(t) if self.name == "fp8" else t

    def linear(self, x, w, b=None):
        y = torch.matmul(self.operand(x), self.operand(w).t())
        return y if b is None else y + b.float()

    def conv1d(self, x, w, b, **kw):
        return F.conv1d(self.operand(x), self.operand(w), b.float(), **kw)

    def conv2d(self, x, w, b, **kw):
        return F.conv2d(self.operand(x), self.operand(w), b.float(), **kw)

    def bmm(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))


# ---------------------------------------------------------------------------
# the model


def groups_of(channels):
    """The reference model's GroupNorm groups: 32 where they divide the
    channels, else the first of 32, 16, 8, 4, 2 that does, else 1."""
    return next((g for g in (32, 16, 8, 4, 2) if channels % g == 0), 1)


def group_norm(x, w, b, eps=1e-5):
    """GroupNorm over (time, channels of the group) of (B, T, C), padding
    frames included, as the reference model normalizes."""
    B, T, C = x.shape
    groups = groups_of(C)
    xg = x.reshape(B, T, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((xg - mean) / torch.sqrt(var + eps)).reshape(B, T, C) * w + b


def rope(T, dh, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
    ang = torch.outer(torch.arange(T, dtype=torch.float64), inv)
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().float().to(device), emb.sin().float().to(device)


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


class Reference:
    """The model's function over a state dict ``sd`` (the reference
    model's names) and ``cfg`` (a dict of the configuration file)."""

    def __init__(self, sd, cfg, precision="fp32"):
        self.sd = sd
        self.cfg = cfg
        self.p = Precision(precision)

    def w(self, name):
        return self.sd[name].float()

    def lin(self, prefix, x):
        return self.p.linear(x, self.w(prefix + ".weight"), self.w(prefix + ".bias"))

    def gn(self, prefix, x):
        return group_norm(x, self.w(prefix + ".norm.weight"), self.w(prefix + ".norm.bias"))

    def ff(self, prefix, x):
        h1, h2 = self.lin(prefix + ".linear1", x).chunk(2, dim=-1)
        return self.lin(prefix + ".linear2", F.silu(h1) * h2)

    def attn(self, prefix, x, mask):
        B, T, D = x.shape
        H = self.cfg["n_heads"]
        dh = D // H
        q = self.lin(prefix + ".linear_q", x).reshape(B, T, H, dh)
        k = self.lin(prefix + ".linear_k", x).reshape(B, T, 1, dh)
        v = self.lin(prefix + ".linear_v", x).reshape(B, T, 1, dh)
        cos, sin = rope(T, dh, x.device)
        cos, sin = cos[None, :, None], sin[None, :, None]
        q = rotate(q, cos, sin).transpose(1, 2)                    # (B, H, T, dh)
        k = rotate(k, cos, sin).transpose(1, 2)                    # (B, 1, T, dh)
        v = v.transpose(1, 2)
        scores = self.p.bmm(q, k.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores + (mask.float()[:, None, None, :] - 1.0) * MASK_SHIFT
        p = torch.softmax(scores, dim=-1)
        ctx = self.p.bmm(p, v).transpose(1, 2).reshape(B, T, D)
        return self.lin(prefix + ".linear_out", ctx)

    def conv(self, prefix, x):
        d = x.shape[-1]
        h = self.gn(prefix + ".norm", x)
        h = self.p.linear(h, self.w(prefix + ".pointwise_conv1.weight")[:, :, 0],
                          self.w(prefix + ".pointwise_conv1.bias"))
        h = h[..., :d] * torch.sigmoid(h[..., d:])
        k = self.cfg["conv_kernel_size"]
        h = self.p.conv1d(h.transpose(1, 2), self.w(prefix + ".depthwise_conv.weight"),
                          self.w(prefix + ".depthwise_conv.bias"), padding=(k - 1) // 2,
                          groups=d).transpose(1, 2)
        bn = prefix + ".batch_norm"
        mean, var = self.w(bn + ".running_mean"), self.w(bn + ".running_var")
        h = (h - mean) / torch.sqrt(var + 1e-5) * self.w(bn + ".weight") + self.w(bn + ".bias")
        h = F.silu(h)
        h = self.p.linear(h, self.w(prefix + ".pointwise_conv2.weight")[:, :, 0],
                          self.w(prefix + ".pointwise_conv2.bias"))
        return h

    def forward(self, feats, frame_lengths):
        """(B, T, n_mels) features and (B,) frame counts -> (B, T', V)
        float32 logits."""
        cfg = self.cfg
        h = feats.float()[:, None]
        for i in (0, 2):
            h = F.silu(self.p.conv2d(h, self.w(f"subsample.{i}.weight"),
                                     self.w(f"subsample.{i}.bias"), stride=2, padding=1))
        B, C, Th, Fh = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh)
        mask = torch.arange(Th, device=h.device)[None, :] < (frame_lengths // 4)[:, None]
        h = self.lin("input_proj", h)
        for i in range(cfg["n_blocks"]):
            pre = f"blocks.{i}"
            h = h + 0.5 * self.ff(pre + ".ff1", self.gn(pre + ".norm_ff1", h))
            h = h + self.attn(pre + ".attn", self.gn(pre + ".norm_attn", h), mask)
            h = h + self.conv(pre + ".conv", h)
            h = h + 0.5 * self.ff(pre + ".ff2", self.gn(pre + ".norm_ff2", h))
            h = self.gn(pre + ".final_norm", h)
        return self.lin("fc", h)


def logits_of(sd, cfg, waves, precision="fp32", device="cpu"):
    """Each row of samples, at the bucket its length falls in, -> a list of
    (valid frames, V) float32 logits. Rows of one bucket run together."""
    out = [None] * len(waves)
    by_bucket = {}
    for i, w in enumerate(waves):
        by_bucket.setdefault(bucket(len(w)), []).append(i)
    ref = Reference(sd, cfg, precision)
    with torch.no_grad(), no_tf32():
        for S, rows in sorted(by_bucket.items()):
            for j in range(0, len(rows), 8):
                part = rows[j:j + 8]
                feats, lengths = features([waves[i] for i in part], S, cfg["n_mels"], device)
                logits = ref.forward(feats, lengths)
                for r, i in enumerate(part):
                    out[i] = logits[r, :int(lengths[r]) // 4].float().cpu()
    return out
