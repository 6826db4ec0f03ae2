"""Seeded weights of Conformer (L) (``configs/conformer_l.json``): the
layout of the program's ``block="conformer"`` model, drawn by the rules of
``asr_bench/weights.py``.

Every linear and convolution weight and bias is uniform in
+-1/sqrt(fan_in), as PyTorch's default initialisation draws them, and so
are ``pos_bias_u`` and ``pos_bias_v`` (fan-in: the head size, 64);
``linear_pos`` has no bias; LayerNorms at weight 1 and bias 0; BatchNorm at
mean 0 and variance 1. One draw on the device from the seed, in layout
order; ``served`` rounds it to bfloat16, the type the configuration serves
its products in.
"""

import math

import torch


def layout(cfg):
    """[(name, shape, kind)] of the state dict, in order; kind is "draw"
    (with its fan-in as a fourth entry), "ones", "zeros" or "count"."""
    d, V, k, n_mels = cfg["d_model"], cfg["n_classes"], cfg["conv_kernel_size"], cfg["n_mels"]
    f = d * cfg["ff_mult"]
    H = cfg["n_heads"]
    out = []

    def dense(name, o, i, tail=(), bias=True):
        fan = i * (math.prod(tail) if tail else 1)
        out.append((f"{name}.weight", (o, i, *tail), "draw", fan))
        if bias:
            out.append((f"{name}.bias", (o,), "draw", fan))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ones"))
        out.append((f"{name}.bias", (d,), "zeros"))

    dense("subsample.0", d, 1, tail=(3, 3))
    dense("subsample.2", d, d, tail=(3, 3))
    dense("input_proj", d, d * (n_mels // 4))
    for b in range(cfg["n_blocks"]):
        p = f"blocks.{b}"
        dense(f"{p}.ff1.linear1", f, d)
        dense(f"{p}.ff1.linear2", d, f)
        norm(f"{p}.norm_ff1")
        out.append((f"{p}.attn.pos_bias_u", (H, d // H), "draw", d // H))
        out.append((f"{p}.attn.pos_bias_v", (H, d // H), "draw", d // H))
        for n in ("q", "k", "v", "out"):
            dense(f"{p}.attn.linear_{n}", d, d)
        dense(f"{p}.attn.linear_pos", d, d, bias=False)
        norm(f"{p}.norm_attn")
        norm(f"{p}.conv.norm")
        dense(f"{p}.conv.pointwise_conv1", 2 * d, d, tail=(1,))
        dense(f"{p}.conv.depthwise_conv", d, 1, tail=(k,))
        norm(f"{p}.conv.batch_norm")
        out.append((f"{p}.conv.batch_norm.running_mean", (d,), "zeros"))
        out.append((f"{p}.conv.batch_norm.running_var", (d,), "ones"))
        out.append((f"{p}.conv.batch_norm.num_batches_tracked", (), "count"))
        dense(f"{p}.conv.pointwise_conv2", d, d, tail=(1,))
        dense(f"{p}.ff2.linear1", f, d)
        dense(f"{p}.ff2.linear2", d, f)
        norm(f"{p}.norm_ff2")
        norm(f"{p}.final_norm")
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
