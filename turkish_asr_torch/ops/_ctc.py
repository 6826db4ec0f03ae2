"""Plain PyTorch versions of the CTC kernels, and the shared topology.

Counterpart of turkish_asr_tpu/ops/ctc.py (``ctc_topology`` :33, the scan
recursion :94-137) and of the Pallas kernels' math
(turkish_asr_tpu/ops/_ctc_pallas_impl.py ``_fwd_kernel`` :85,
``_bwd_kernel`` :114, ``_ctc_bwd`` :301): the alpha recursion and the
time-reversed beta recursion with the analytic gradient
d nll / d emit[t, s] = -exp(alpha[t, s] + beta[t, s] - ll), looped over T
in PyTorch and vectorized over (B, S). ``ops/ctc.py`` runs them for tensors
on the CPU; tests and ``chip_smoke.py`` hold ``csrc/ctc_fwd.cu`` and
``csrc/ctc_bwd.cu`` against them. Same logaddexp
(max + log1p(exp(-|a - b|))), same association, same finite sentinel.
"""

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite stand-in for log 0, as the JAX package uses


def logaddexp(a, b):
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def ctc_topology(targets, blank_id):
    """(ext, allow_skip): (B, 2L+1) blank-interleaved extended labels, and
    the s-2 transition allowed only at a label that differs from the label
    two lanes back (ops/ctc.py:33)."""
    B, L = targets.shape
    S = 2 * L + 1
    ext = torch.full((B, S), blank_id, dtype=torch.int32, device=targets.device)
    ext[:, 1::2] = targets.to(torch.int32)
    shift2 = F.pad(ext, (2, 0), value=blank_id)[:, :S]
    pos = torch.arange(S, device=targets.device)[None, :]
    allow_skip = (pos % 2 == 1) & (ext != shift2)
    return ext, allow_skip


def label_chains(ext):
    """(next_same int32, leader bool), both (B, S): the next lane with the
    same label (-1 after the last) and whether a lane is its label's first.
    The backward kernel sums each label's lanes along this chain, in
    increasing s, so the scatter to (B, T, V) needs no atomics."""
    B, S = ext.shape
    lane = torch.arange(S, device=ext.device)
    order = (ext.to(torch.int64) * S + lane[None, :]).argsort(dim=1)
    lab = ext.gather(1, order)
    same = lab[:, 1:] == lab[:, :-1]
    nxt_sorted = torch.cat([torch.where(same, order[:, 1:], -1),
                            torch.full((B, 1), -1, dtype=order.dtype, device=ext.device)], 1)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=ext.device), ~same], 1)
    next_same = torch.empty_like(order).scatter_(1, order, nxt_sorted)
    leader = torch.empty_like(first).scatter_(1, order, first)
    return next_same.to(torch.int32), leader


def _emissions(log_probs, ext):
    B, T, V = log_probs.shape
    idx = ext.to(torch.int64).clamp(0, V - 1)
    return log_probs.gather(2, idx[:, None, :].expand(B, T, ext.shape[1]))


def ctc_fwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths):
    """(nll (B,), alpha (B, T, S)) of the alpha recursion; alpha is frozen
    from t = input_length on, as the kernels freeze it."""
    B, T, _ = log_probs.shape
    S = ext.shape[1]
    emit = _emissions(log_probs, ext)
    il = input_lengths.to(torch.int64)[:, None]
    tl = target_lengths.to(torch.int64)
    pos = torch.arange(S, device=log_probs.device)[None, :]
    alpha = torch.where(pos == 0, emit[:, 0], NEG_INF)
    alpha = torch.where((pos == 1) & (tl[:, None] > 0), emit[:, 0], alpha)
    alphas = [alpha]
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :S]
        a2 = F.pad(alpha, (2, 0), value=NEG_INF)[:, :S]
        acc = logaddexp(alpha, a1)
        acc = torch.where(allow_skip, logaddexp(acc, a2), acc)
        alpha = torch.where(t < il, acc + emit[:, t], alpha)
        alphas.append(alpha)
    hi = (2 * tl).clamp(max=S - 1)[:, None]
    lo = (2 * tl - 1).clamp(min=0, max=S - 1)[:, None]
    ll = torch.where(tl > 0, logaddexp(alpha.gather(1, hi)[:, 0], alpha.gather(1, lo)[:, 0]),
                     alpha[:, 0])
    return -ll, torch.stack(alphas, dim=1)


def ctc_bwd_ref(log_probs, ext, allow_skip, input_lengths, target_lengths, alpha, nll, cot):
    """(B, T, V) gradient of nll * cot with respect to log_probs: the beta
    recursion, -exp(alpha + beta - ll) per lane (0 at padded frames), scaled
    by the cotangent and added into each lane's label."""
    B, T, V = log_probs.shape
    S = ext.shape[1]
    emit = _emissions(log_probs, ext)
    il = input_lengths.to(torch.int64)[:, None]
    tl = target_lengths.to(torch.int64)[:, None]
    pos = torch.arange(S, device=log_probs.device)[None, :]
    final = torch.where((pos == 2 * tl) | ((pos == (2 * tl - 1).clamp(min=0)) & (tl > 0)),
                        0.0, NEG_INF)
    skip2 = F.pad(allow_skip[:, 2:], (0, 2), value=False)
    ll = -nll[:, None]
    beta = torch.full((B, S), NEG_INF, device=log_probs.device)
    emit_next = torch.zeros((B, S), device=log_probs.device)
    grads = [None] * T
    for t in range(T - 1, -1, -1):
        y = emit_next + beta
        y1 = F.pad(y[:, 1:], (0, 1), value=NEG_INF)
        y2 = torch.where(skip2, F.pad(y[:, 2:], (0, 2), value=NEG_INF), NEG_INF)
        cand = logaddexp(logaddexp(y, y1), y2)
        beta = torch.where(t == il - 1, final, torch.where(t < il - 1, cand, beta))
        grads[t] = torch.where(t < il, -torch.exp(alpha[:, t] + beta - ll), 0.0)
        emit_next = emit[:, t]
    grad_emit = torch.stack(grads, dim=1) * cot[:, None, None]
    idx = ext.to(torch.int64).clamp(0, V - 1)[:, None, :].expand(B, T, S)
    return torch.zeros((B, T, V), device=log_probs.device).scatter_add_(2, idx, grad_emit)
