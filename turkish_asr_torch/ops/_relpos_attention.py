"""Plain PyTorch version of the relative-position attention kernel.

The same function as ``csrc/flash_attention_relpos_fwd.cu``, written as
whole-tensor PyTorch with the scores materialised: the wrapper in
``ops/relpos_attention.py`` runs it for tensors on the CPU, and the card
tests hold the kernel against it. For head h, query i and key j
(Transformer-XL, Dai et al. 2019, sec. 3.3, as Conformer uses it):

    S[i, j] = ((q_i + u_h) . k_j + (q_i + v_h) . p[T-1-i+j]) / sqrt(D)
              + (0 if j < length else -1e9)
    out_i   = softmax_j(S[i]) @ v

``p`` holds the relative positions in descending order, ESPnet's: row m
is the embedding of the distance T-1-m, so row T-1-i+j is that of i - j.
The position term is computed against all 2T-1 rows and the column of
each (i, j) taken by an index; the tests hold it to the pad-view-slice
rel-shift of ESPnet.
"""

import math

import torch

MASK_SHIFT = 1e9


def relpos_scores(q, k, p, pos_bias_u, pos_bias_v, lengths):
    """(B, H, T, T) fp32 scaled scores with the key mask's shift.

    q, k (B, T, H, D); p (2T-1, H, D); pos_bias_u, pos_bias_v (H, D);
    lengths (B,) integers: key j of row b is valid where j < lengths[b]."""
    B, T, H, D = q.shape
    qf = q.float().transpose(1, 2)                                    # (B, H, T, D)
    kf = k.float().transpose(1, 2)
    pf = p.float().permute(1, 0, 2)                                   # (H, 2T-1, D)
    content = torch.matmul(qf + pos_bias_u.float()[None, :, None], kf.transpose(-1, -2))
    position = torch.matmul(qf + pos_bias_v.float()[None, :, None], pf.transpose(-1, -2))
    i = torch.arange(T, device=q.device)
    column = (T - 1 - i)[:, None] + i[None, :]                        # (T, T): T-1-i+j
    position = position.gather(-1, column.expand(B, H, T, T))
    valid = i[None, :] < lengths.to(q.device)[:, None]                # (B, T) keys
    shift = (valid.float() - 1.0) * MASK_SHIFT
    return (content + position) * (1.0 / math.sqrt(D)) + shift[:, None, None, :]


def relpos_attention_ref(q, k, v, p, pos_bias_u, pos_bias_v, lengths):
    """(B, T, H, D) context in q's dtype: softmax of ``relpos_scores``
    times v, in fp32."""
    scores = relpos_scores(q, k, p, pos_bias_u, pos_bias_v, lengths)
    out = torch.matmul(torch.softmax(scores, dim=-1), v.float().transpose(1, 2))
    return out.transpose(1, 2).to(q.dtype).contiguous()
