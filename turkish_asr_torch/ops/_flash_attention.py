"""Plain PyTorch version of the flash-attention forward kernel.

The same function as ``csrc/flash_attention_fwd.cu`` and as the TPU
kernel's tile body ``_attend`` (turkish_asr_tpu/ops/_flash_attention_impl.py
:71-92), written as whole-tensor PyTorch: the wrapper in
``ops/flash_attention.py`` runs it for tensors on the CPU, and tests and
``chip_smoke.py`` hold the kernel against it.
"""

import math

import torch

MASK_SHIFT = 1e9


def flash_attention_fwd_ref(q, k, v, mask=None):
    """softmax(q k^T / sqrt(D) + (mask - 1) * 1e9) v, and the row logsumexp.

    Args:
        q: (B, H, T, D) in the compute dtype.
        k, v: (B, Kh, T, D) with Kh == 1 (MQA: the one KV head is broadcast,
            not expanded) or Kh == H.
        mask: optional (B, T) bool or uint8 key validity.

    Returns:
        out (B, H, T, D) fp32 and lse (B, H, T) fp32. Scores and softmax
        are fp32; the probabilities are cast to v's dtype before ``p @ v``,
        which accumulates in fp32.
    """
    B, H, T, D = q.shape
    Kh = k.shape[1]
    if Kh not in (1, H):
        raise ValueError(f"k/v heads must be 1 or {H}, got {Kh}")
    scale = 1.0 / math.sqrt(D)
    if Kh == 1:
        # Heads folded into rows, as the MQA kernel folds them.
        qf = q.reshape(B, 1, H * T, D)
    else:
        qf = q
    scores = torch.matmul(qf.float(), k.float().transpose(-1, -2)) * scale
    if mask is None:
        maskf = torch.ones((B, T), dtype=torch.float32, device=q.device)
    else:
        maskf = mask.to(torch.float32)
    scores = scores + (maskf[:, None, None, :] - 1.0) * MASK_SHIFT
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    p = e / s
    lse = (m + torch.log(s))[..., 0]
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.reshape(B, H, T, D), lse.reshape(B, H, T)
