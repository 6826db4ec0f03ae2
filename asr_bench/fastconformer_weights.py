"""Seeded weights of FastConformer XXL (``configs/fastconformer_xxl.json``,
Parakeet-CTC 1.1B): the layout of the program's ``block="conformer"`` model
with the ``dw_striding8`` subsample, drawn by the rules of
``asr_bench/relpos_weights.py``.

The subsample is NeMo's: ``subsample.0`` Conv2d(1, C, 3x3), then
``subsample.2``/``.3`` and ``.5``/``.6``, each a depthwise Conv2d(C, 1, 3x3)
and a pointwise Conv2d(C, C, 1x1); ``input_proj`` takes C times the mel bins
after three halvings (10 of 80). The blocks are ``relpos_weights.layout``'s.
Every linear and convolution weight and bias is uniform in +-1/sqrt(fan_in),
and so are ``pos_bias_u`` and ``pos_bias_v`` (fan-in: the head size, 128);
LayerNorms at weight 1 and bias 0; BatchNorm at mean 0 and variance 1. One
draw on the device from the seed, in layout order; ``served`` rounds it to
bfloat16, the type the configuration serves its products in.
"""

import math

import torch

from asr_bench import relpos_weights


def mel_bins(n_mels):
    """Mel bins after the subsample's three stride-2 convolutions."""
    for _ in range(3):
        n_mels = (n_mels - 1) // 2 + 1
    return n_mels


def layout(cfg):
    """[(name, shape, kind)] of the state dict, in order; kind is "draw"
    (with its fan-in as a fourth entry), "ones", "zeros" or "count"."""
    d, C = cfg["d_model"], cfg["subsample_channels"]
    out = []

    def dense(name, o, i, tail=()):
        fan = i * (math.prod(tail) if tail else 1)
        out.append((f"{name}.weight", (o, i, *tail), "draw", fan))
        out.append((f"{name}.bias", (o,), "draw", fan))

    dense("subsample.0", C, 1, tail=(3, 3))
    for i in (2, 5):
        dense(f"subsample.{i}", C, 1, tail=(3, 3))
        dense(f"subsample.{i + 1}", C, C, tail=(1, 1))
    dense("input_proj", d, C * mel_bins(cfg["n_mels"]))
    out += [e for e in relpos_weights.layout(cfg) if e[0].startswith("blocks.")]
    dense("fc", cfg["n_classes"], d)
    return out


def make_state_dict(cfg, seed, device, served=False):
    """The seeded state dict on ``device`` (float32 tensors; rounded
    through bfloat16 with ``served``)."""
    spec = layout(cfg)
    total = sum(math.prod(s[1]) for s in spec if s[2] == "draw")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    sd, at = {}, 0
    for name, shape, kind, *fan in spec:
        if kind == "draw":
            n = math.prod(shape)
            t = flat[at:at + n].reshape(shape) / math.sqrt(fan[0])
            at += n
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        if served and t.is_floating_point():
            t = t.to(torch.bfloat16).float()
        sd[name] = t.contiguous()
    return sd


def param_count(cfg):
    """Trainable parameters: every drawn tensor and every norm's weight and
    bias (not BatchNorm's running statistics)."""
    return sum(math.prod(s[1]) for s in layout(cfg) if s[2] in ("draw", "ones", "zeros")
               and not s[0].endswith(("running_mean", "running_var")))
