"""Plain PyTorch versions of the flash-attention kernels.

The same functions as ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` and as the TPU kernels' tile bodies
``_attend`` and ``_bwd_tile`` (turkish_asr_tpu/ops/_flash_attention_impl.py
:71-92, :317-374), written as whole-tensor PyTorch: the wrapper in
``ops/flash_attention.py`` runs them for tensors on the CPU, and tests and
``chip_smoke.py`` hold the kernels against them. With a dropout rate the
keep mask is ``ops/_dropout.keep_mask_ref``, the kernels' own hash, so
kernel and plain version drop the same weights.
"""

import math

import torch

from turkish_asr_torch.ops._dropout import keep_mask_ref

MASK_SHIFT = 1e9


def _scores(q, k, mask):
    """(B, 1 or H, rows, T) fp32 scaled scores plus the mask shift; MQA
    folds the heads into rows as the kernels do."""
    B, H, T, D = q.shape
    qf = q.reshape(B, 1, H * T, D) if k.shape[1] == 1 else q
    scores = torch.matmul(qf.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if mask is None:
        maskf = torch.ones((B, T), dtype=torch.float32, device=q.device)
    else:
        maskf = mask.to(torch.float32)
    return scores + (maskf[:, None, None, :] - 1.0) * MASK_SHIFT


def _keep_scale(B, H, T, Kh, rate, seed, device):
    """(B, 1 or H, rows, T) fp32: 1/(1 - rate) where kept, 0 where dropped."""
    keep = keep_mask_ref(seed, B, H, T, rate, device)
    if Kh == 1:
        keep = keep.reshape(B, 1, H * T, T)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    return torch.where(keep, inv, torch.zeros((), device=device))


def flash_attention_fwd_stats_ref(q, k, v, mask=None, dropout_rate=0.0, seed=0):
    """(out, lse, row_max, row_sum): the forward kernel's outputs.

    out (B, H, T, D) fp32; lse, row_max, row_sum (B, H, T) fp32 (the
    softmax's logsumexp, max m and sum l relative to m). With a dropout rate
    the normalized p is scaled by 1/(1 - rate) where kept and zeroed where
    dropped before it is cast to v's dtype; lse is taken before dropout.
    """
    B, H, T, D = q.shape
    Kh = k.shape[1]
    if Kh not in (1, H):
        raise ValueError(f"k/v heads must be 1 or {H}, got {Kh}")
    scores = _scores(q, k, mask)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    p = e / s
    lse = (m + torch.log(s))[..., 0]
    if dropout_rate > 0.0:
        keep = _keep_scale(B, H, T, Kh, dropout_rate, seed, q.device)
        p = torch.where(keep > 0, p * keep, 0.0)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out.reshape(B, H, T, D), lse.reshape(B, H, T), m.reshape(B, H, T),
            s.reshape(B, H, T))


def flash_attention_fwd_ref(q, k, v, mask=None, dropout_rate=0.0, seed=0):
    """softmax(q k^T / sqrt(D) + (mask - 1) * 1e9) v, and the row logsumexp.

    Args:
        q: (B, H, T, D) in the compute dtype.
        k, v: (B, Kh, T, D) with Kh == 1 (MQA: the one KV head is broadcast,
            not expanded) or Kh == H.
        mask: optional (B, T) bool or uint8 key validity.
        dropout_rate, seed: attention-weight dropout (``ops/_dropout.py``).

    Returns:
        out (B, H, T, D) fp32 and lse (B, H, T) fp32. Scores and softmax
        are fp32; the probabilities are cast to v's dtype before ``p @ v``,
        which accumulates in fp32.
    """
    out, lse, _, _ = flash_attention_fwd_stats_ref(q, k, v, mask, dropout_rate, seed)
    return out, lse


def flash_attention_bwd_ref(q, k, v, mask, row_max, row_sum, delta, g, dropout_rate=0.0,
                            seed=0):
    """(dq, dk, dv) fp32 of the forward, as the backward kernel computes them.

    p = exp(s - m) / l rebuilds the forward's probabilities (also for a row
    with no valid key, where exp(s - lse) would not: its lse rounds to
    -1e9); with y = p * keep and dp = (g @ v^T) * keep,
    ds = p * (dp - delta) * scale, dq = ds @ k, dk = ds^T @ q, dv = y^T @ g.
    ``delta`` = rowsum(g * out), (B, H, T).
    """
    B, H, T, D = q.shape
    Kh = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    rows = (B, 1, H * T) if Kh == 1 else (B, H, T)
    scores = _scores(q, k, mask)
    p = torch.exp(scores - row_max.reshape(rows)[..., None]) / row_sum.reshape(rows)[..., None]
    gf = g.float().reshape(*rows, D)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = _keep_scale(B, H, T, Kh, dropout_rate, seed, q.device)
        y, dp = p * keep, dp * keep
    else:
        y = p
    ds = p * (dp - delta.reshape(rows)[..., None]) * scale
    dq = torch.matmul(ds, k.float())
    qf = q.float().reshape(*rows, D)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(y.transpose(-1, -2), gf)
    return dq.reshape(B, H, T, D), dk, dv
