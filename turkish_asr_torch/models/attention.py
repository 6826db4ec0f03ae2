"""RoPE + multi-query attention for the Conformer encoder.

Counterpart of turkish_asr_tpu/models/attention.py. Parameter names are the
reference ``state_dict`` keys (``linear_q``, ``linear_k``, ``linear_v``,
``linear_out``, ``rotary_emb.inv_freq``). The cast points follow the JAX
module: projections add their bias in fp32 and then cast to the compute
dtype; the RoPE tables are cast to the activation dtype; the attention
core is ``ops.flash_attention`` (the Hopper kernels on CUDA tensors, their
plain versions on CPU tensors; differentiable, with attention-weight
dropout inside the kernel in training), which returns fp32 context.
"""

import threading
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from turkish_asr_torch.ops.flash_attention import flash_attention


@lru_cache(maxsize=16)
def _rope_tables_np(seq_len, dim, base):
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@lru_cache(maxsize=32)
def rope_cos_sin(seq_len, dim, dtype, device, base=10000.0):
    """(seq_len, dim) cos and sin tables from fp64 host math, in ``dtype``.

    Made outside inference mode even when a served forward asks first: the
    cache hands the same tensors to training, whose backward cannot save
    inference tensors."""
    cos, sin = _rope_tables_np(int(seq_len), int(dim), float(base))
    with torch.inference_mode(False):
        return (torch.from_numpy(cos).to(device=device, dtype=dtype),
                torch.from_numpy(sin).to(device=device, dtype=dtype))


def rope_tables(seq_len, dim, dtype, device, base=10000.0):
    """``rope_cos_sin``'s tables from torch ops in fp64 on ``device``, for
    a symbolic ``seq_len`` (``torch.export``), where the cache would
    specialize the program to one length; the JAX module
    (turkish_asr_tpu/models/attention.py:38-53) splits its tables the same
    way. Within one fp32 ulp of the numpy tables."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float64, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float().to(dtype), emb.sin().float().to(dtype)


def rope_inv_freq(d_head):
    """The reference's ``rotary_emb.inv_freq`` buffer (fp32 numpy math, as
    turkish_asr_tpu/utils/torch_export.py writes it)."""
    return torch.from_numpy(
        1.0 / (10000.0 ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head)))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    return x * cos + rotate_half(x) * sin


class _DenseProducts(threading.local):
    """Whether this thread is inside a ``dense`` product (read by the
    ``--remat_policy dots`` checkpoint policy)."""
    depth = 0


_DENSE = _DenseProducts()


def in_dense_product():
    """True while a ``dense`` layer's product runs on this thread: the
    linear layers' products are the ones JAX's ``dots`` remat policy
    saves; the pointwise convolutions' matmuls, which JAX computes as
    convolutions, are not among them."""
    return _DENSE.depth > 0


def dense(linear, x, compute_dtype):
    """``x @ W^T + b``: the product in ``compute_dtype``, the bias added in
    fp32, the result cast back to ``compute_dtype``.

    JAX keeps the product in fp32 before the bias add; PyTorch has no
    bf16 GEMM with an fp32 result on the CPU, so under bf16 the product is
    rounded to bf16 once more than in JAX. In fp32 the two agree.
    """
    _DENSE.depth += 1
    try:
        out = torch.matmul(x.to(compute_dtype), linear.weight.to(compute_dtype).t())
    finally:
        _DENSE.depth -= 1
    return (out.float() + linear.bias.float()).to(compute_dtype)


class RotaryEmbedding(nn.Module):
    """Holds the reference's ``inv_freq`` buffer so a reference ``.pt``
    loads strictly. The tables themselves come from ``rope_cos_sin``."""

    def __init__(self, d_head):
        super().__init__()
        self.register_buffer("inv_freq", rope_inv_freq(d_head))


class MultiQueryAttention(nn.Module):
    """Self-attention with RoPE and one shared KV head (``use_mqa``), or
    per-head K/V."""

    def __init__(self, d_model, n_heads, use_mqa=True):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.kv_heads = 1 if use_mqa else n_heads
        kv_dim = self.d_head * self.kv_heads
        self.rotary_emb = RotaryEmbedding(self.d_head)
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, kv_dim)
        self.linear_v = nn.Linear(d_model, kv_dim)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, x, mask=None, compute_dtype=torch.float32, dropout=0.0, seed=0):
        """x (B, T, D) normalized input; mask (B, T) bool. -> (B, T, D).

        ``dropout`` > 0 drops attention weights inside the attention kernel
        with the position hash keyed by ``seed`` (training)."""
        B, T, D = x.shape
        H, Kh, Dh = self.n_heads, self.kv_heads, self.d_head
        q = dense(self.linear_q, x, compute_dtype).reshape(B, T, H, Dh)
        k = dense(self.linear_k, x, compute_dtype).reshape(B, T, Kh, Dh)
        v = dense(self.linear_v, x, compute_dtype).reshape(B, T, Kh, Dh)
        tables = rope_tables if isinstance(T, torch.SymInt) else rope_cos_sin
        cos, sin = tables(T, Dh, q.dtype, q.device)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        q = apply_rope(q, cos, sin).transpose(1, 2).contiguous()  # (B, H, T, Dh)
        k = apply_rope(k, cos, sin).transpose(1, 2).contiguous()  # (B, Kh, T, Dh)
        v = v.transpose(1, 2).contiguous()
        context, _ = flash_attention(q, k, v, mask, dropout, seed)
        context = context.transpose(1, 2).reshape(B, T, D)
        return dense(self.linear_out, context, compute_dtype)
