"""RoPE + multi-query attention for the Conformer encoder, and the
relative-position multi-head attention of Conformer (L).

Counterpart of turkish_asr_tpu/models/attention.py. Parameter names are the
reference ``state_dict`` keys (``linear_q``, ``linear_k``, ``linear_v``,
``linear_out``, ``rotary_emb.inv_freq``). The cast points follow the JAX
module: projections add their bias in fp32 and then cast to the compute
dtype (``ops.bias_act``: one hand-written kernel on the card in bf16); the
RoPE tables are cast to the activation dtype; the attention core is
``ops.flash_attention`` (the Hopper kernels on CUDA tensors, their
plain versions on CPU tensors; differentiable, with attention-weight
dropout inside the kernel in training), which returns fp32 context. With
``attn_kernel=False`` (the bench's kernel-off runs, JAX's
``attn_kernel=None``) the core is ``ops.flash_attention_plain`` instead,
the plain version on any device; nothing picks it by itself.

On a mesh (``parallel/mesh.py``) ``linear_q`` holds this "model" rank's
heads and ``linear_out`` their input columns (row-parallel, one all-reduce
after it); ``linear_k``/``linear_v`` (one KV head) are replicated. The
kernel runs on every head and all ``T'`` frames, gathered over "model"
and "seq" at its entry as JAX's ``shard_map(P("data"))`` gathers them,
and each rank keeps its heads and frames of the context. Each model rank's
gradient into k and v covers its heads only, so k and v pass through
``copy_to``, whose backward sums them over the model group.

``RelPositionMultiHeadAttention`` is the attention of Gulati et al. 2020
(Conformer, arXiv:2005.08100) with Transformer-XL's relative positions
(arXiv:1901.02860, sec. 3.3): full K/V heads, no RoPE, the sinusoid of each
relative distance projected by ``linear_pos`` (no bias) and the learned
``pos_bias_u`` and ``pos_bias_v`` of each head; its core is
``ops.relpos_attention`` (the Hopper kernel on CUDA tensors, the plain
version on CPU tensors). It runs on one process only.
"""

import threading
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from turkish_asr_torch.ops.bias_act import bias_act
from turkish_asr_torch.ops.flash_attention import flash_attention, flash_attention_plain
from turkish_asr_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain
from turkish_asr_torch.parallel.collectives import all_gather, copy_to, reduce_from
from turkish_asr_torch.parallel.mesh import axis_group, seq_bounds


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


def dense(linear, x, compute_dtype, group=None, act="none"):
    """``act(x @ W^T + b)``: the product in ``compute_dtype``, the bias added
    in fp32, the result cast back to ``compute_dtype``, then ``act``
    ("none", "relu" or "silu"), all in ``ops.bias_act``.

    JAX keeps the product in fp32 before the bias add; PyTorch has no
    bf16 GEMM with an fp32 result on the CPU, so under bf16 the product is
    rounded to bf16 once more than in JAX. In fp32 the two agree.

    With ``group`` the layer is row-parallel: the fp32 partial products
    are summed over the group (``reduce_from``) before the one bias add.
    """
    _DENSE.depth += 1
    try:
        out = torch.matmul(x.to(compute_dtype), linear.weight.to(compute_dtype).t())
    finally:
        _DENSE.depth -= 1
    if group is not None:
        out = reduce_from(out.float(), group)
    return bias_act(out, linear.bias, compute_dtype, act)


class RotaryEmbedding(nn.Module):
    """Holds the reference's ``inv_freq`` buffer so a reference ``.pt``
    loads strictly. The tables themselves come from ``rope_cos_sin``."""

    def __init__(self, d_head):
        super().__init__()
        self.register_buffer("inv_freq", rope_inv_freq(d_head))


class MultiQueryAttention(nn.Module):
    """Self-attention with RoPE and one shared KV head (``use_mqa``), or
    per-head K/V."""

    mesh = None

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

    def forward(self, x, mask=None, compute_dtype=torch.float32, dropout=0.0, seed=0,
                span=None, attn_kernel=True):
        """x (B, T, D) normalized input; mask (B, T) bool. -> (B, T, D).

        ``dropout`` > 0 drops attention weights inside the attention kernel
        with the position hash keyed by ``seed`` (training). Over "seq" x
        holds frames t0:t1 of ``span`` (t0, t1, T) and ``mask`` all T.
        ``attn_kernel=False`` runs the core through its plain version."""
        model, seq = axis_group(self.mesh, "model"), axis_group(self.mesh, "seq")
        B, Tl, D = x.shape
        H, Kh, Dh = self.n_heads, self.kv_heads, self.d_head
        Hl = H // (1 if model is None else model.size)
        q = dense(self.linear_q, copy_to(x, model), compute_dtype).reshape(B, Tl, Hl, Dh)
        k = copy_to(dense(self.linear_k, x, compute_dtype), model).reshape(B, Tl, Kh, Dh)
        v = copy_to(dense(self.linear_v, x, compute_dtype), model).reshape(B, Tl, Kh, Dh)
        q = all_gather(q, 2, model)
        if seq is not None:
            sizes = [b - a for a, b in seq_bounds(span[2], seq.size)]
            q, k, v = (all_gather(t, 1, seq, sizes) for t in (q, k, v))
        T = q.shape[1]
        tables = rope_tables if isinstance(T, torch.SymInt) else rope_cos_sin
        cos, sin = tables(T, Dh, q.dtype, q.device)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        q = apply_rope(q, cos, sin).transpose(1, 2).contiguous()  # (B, H, T, Dh)
        k = apply_rope(k, cos, sin).transpose(1, 2).contiguous()  # (B, Kh, T, Dh)
        v = v.transpose(1, 2).contiguous()
        # On a mesh the kernel's seed takes the data rank (``flash_attention``).
        shard = {} if self.mesh is None else {"data_rank": self.mesh.index("data")}
        core = flash_attention if attn_kernel else flash_attention_plain
        context, _ = core(q, k, v, mask, dropout, seed, **shard)
        context = context.transpose(1, 2)  # (B, T, H, Dh)
        if model is not None or seq is not None:  # this rank's frames and heads
            t0, t1 = (0, T) if seq is None else span[:2]
            h0 = 0 if model is None else model.index * Hl
            context = context[:, t0:t1, h0:h0 + Hl]
        return dense(self.linear_out, context.reshape(B, Tl, Hl * Dh), compute_dtype, model)


@lru_cache(maxsize=16)
def _rel_pos_table_np(seq_len, dim):
    r = np.arange(seq_len - 1, -seq_len, -1, dtype=np.float64)
    omega = 10000.0 ** (-np.arange(0, dim, 2, dtype=np.float64) / dim)
    angle = np.outer(r, omega)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(np.float32)


@lru_cache(maxsize=32)
def rel_pos_table(seq_len, dim, dtype, device):
    """(2 seq_len - 1, dim) sinusoids of the relative distances from
    seq_len - 1 down to -(seq_len - 1): row m is [sin(r w) | cos(r w)] at
    r = seq_len - 1 - m, w_i = 10000^(-2i/dim), from fp64 host math, in
    ``dtype`` (made outside inference mode, as ``rope_cos_sin``)."""
    table = _rel_pos_table_np(int(seq_len), int(dim))
    with torch.inference_mode(False):
        return torch.from_numpy(table).to(device=device, dtype=dtype)


class RelPositionMultiHeadAttention(nn.Module):
    """Multi-head self-attention with relative positions (Conformer (L))."""

    mesh = None

    def __init__(self, d_model, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, self.d_head))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, self.d_head))

    def forward(self, x, lengths, compute_dtype=torch.float32, attn_kernel=True):
        """x (B, T, D) normalized input; lengths (B,) valid frames. ->
        (B, T, D). ``attn_kernel=False`` runs the core through its plain
        version."""
        B, T, D = x.shape
        H, Dh = self.n_heads, self.d_head
        q, k, v = (dense(lin, x, compute_dtype).view(B, T, H, Dh)
                   for lin in (self.linear_q, self.linear_k, self.linear_v))
        table = rel_pos_table(T, D, compute_dtype, x.device)
        p = torch.matmul(table, self.linear_pos.weight.to(compute_dtype).t()).view(2 * T - 1, H, Dh)
        core = relpos_attention if attn_kernel else relpos_attention_plain
        context = core(q, k, v, p, self.pos_bias_u, self.pos_bias_v, lengths)
        return dense(self.linear_out, context.reshape(B, T, D), compute_dtype)
