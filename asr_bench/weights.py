"""Seeded weights of the benchmark's Conformer-CTC configurations.

The state dict uses the reference model's names (which the program loads
strictly) and is made on the device from the seed in one draw: every
linear and convolution weight and bias uniform in +-1/sqrt(fan_in), as
PyTorch's default initialisation draws them; norms at weight 1 and bias 0;
BatchNorm at mean 0 and variance 1; the RoPE frequencies of the reference
model's buffer. ``served`` rounds the draw to bfloat16, the type the
configurations serve their products in, so a served checkpoint is half the
bytes and the reference reads the same values.
"""

import math

import numpy as np
import torch


def layout(cfg):
    """[(name, shape, kind)] of the state dict, in order; kind is "draw"
    (with its fan-in as a fourth entry), "ones", "zeros", "inv_freq" or
    "count"."""
    d, V, k, n_mels = cfg["d_model"], cfg["n_classes"], cfg["conv_kernel_size"], cfg["n_mels"]
    f = d * cfg["ff_mult"]
    dh = d // cfg["n_heads"]
    out = []

    def dense(name, o, i, fan_in=None, tail=()):
        fan = fan_in or i * (math.prod(tail) if tail else 1)
        out.append((f"{name}.weight", (o, i, *tail), "draw", fan))
        out.append((f"{name}.bias", (o,), "draw", fan))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ones"))
        out.append((f"{name}.bias", (d,), "zeros"))

    dense("subsample.0", d, 1, tail=(3, 3))
    dense("subsample.2", d, d, tail=(3, 3))
    dense("input_proj", d, d * (n_mels // 4))
    for b in range(cfg["n_blocks"]):
        p = f"blocks.{b}"
        dense(f"{p}.ff1.linear1", 2 * f, d)
        dense(f"{p}.ff1.linear2", d, f)
        norm(f"{p}.norm_ff1.norm")
        out.append((f"{p}.attn.rotary_emb.inv_freq", (dh // 2,), "inv_freq"))
        dense(f"{p}.attn.linear_q", d, d)
        dense(f"{p}.attn.linear_k", dh, d)
        dense(f"{p}.attn.linear_v", dh, d)
        dense(f"{p}.attn.linear_out", d, d)
        norm(f"{p}.norm_attn.norm")
        norm(f"{p}.conv.norm.norm")
        dense(f"{p}.conv.pointwise_conv1", 2 * d, d, tail=(1,))
        dense(f"{p}.conv.depthwise_conv", d, 1, tail=(k,))
        norm(f"{p}.conv.batch_norm")
        out.append((f"{p}.conv.batch_norm.running_mean", (d,), "zeros"))
        out.append((f"{p}.conv.batch_norm.running_var", (d,), "ones"))
        out.append((f"{p}.conv.batch_norm.num_batches_tracked", (), "count"))
        dense(f"{p}.conv.pointwise_conv2", d, d, tail=(1,))
        norm(f"{p}.norm_conv.norm")
        dense(f"{p}.ff2.linear1", 2 * f, d)
        dense(f"{p}.ff2.linear2", d, f)
        norm(f"{p}.norm_ff2.norm")
        norm(f"{p}.final_norm.norm")
    dense("fc", V, d)
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
        elif kind == "inv_freq":
            dh = 2 * shape[0]
            t = torch.from_numpy(
                1.0 / (10000.0 ** (np.arange(0, dh, 2, dtype=np.float32) / dh))).to(device)
        else:
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        if served and t.is_floating_point():
            t = t.to(torch.bfloat16).float()
        sd[name] = t.contiguous()
    return sd


def param_count(cfg):
    """Trainable parameters: every drawn tensor and every norm's weight
    and bias but the unused ``norm_conv`` GroupNorm."""
    return sum(math.prod(s[1]) for s in layout(cfg)
               if s[2] in ("draw", "ones", "zeros") and ".norm_conv." not in s[0]
               and not s[0].endswith(("running_mean", "running_var")))
