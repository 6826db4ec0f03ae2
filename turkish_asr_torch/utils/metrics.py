"""WER/CER metrics.

Copied from turkish_asr_tpu/utils/metrics.py (numpy only), without its
native Levenshtein kernel: the edit distance is the two-row dynamic
program. The reference computes WER/CER via the jiwer package
(reference utils/metrics.py:48-50); ``wer``/``cer`` implement the
same corpus-level definition: total edit distance over all pairs divided by
total reference token count. ASRMetrics keeps the reference's decode path:
argmax -> tokenizer.ctc_decode for predictions; strip id==0 then plain
decode for targets; any metric failure (e.g. empty references) yields
1.0/1.0.
"""

import numpy as np


def _edit_distance(ref, hyp):
    """Levenshtein distance between two sequences (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        curr = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            curr[j] = min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + cost)
        prev = curr
    return prev[m]


def wer(references, hypotheses):
    """Corpus word error rate: sum(edit) / sum(ref words)."""
    if isinstance(references, str):
        references, hypotheses = [references], [hypotheses]
    total_edits = 0
    total_words = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        total_edits += _edit_distance(r, h)
        total_words += len(r)
    if total_words == 0:
        raise ValueError("empty reference")
    return total_edits / total_words


def cer(references, hypotheses):
    """Corpus character error rate: sum(edit) / sum(ref chars)."""
    if isinstance(references, str):
        references, hypotheses = [references], [hypotheses]
    total_edits = 0
    total_chars = 0
    for ref, hyp in zip(references, hypotheses):
        total_edits += _edit_distance(list(ref), list(hyp))
        total_chars += len(ref)
    if total_chars == 0:
        raise ValueError("empty reference")
    return total_edits / total_chars


class ASRMetrics:
    """Batch WER/CER from logits + padded targets (reference-compatible)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def compute_from_ids(self, pred_ids, pred_counts, targets):
        """WER/CER from already-collapsed prediction ids (the on-device
        greedy path: only packed ids cross the host boundary, not logits).

        Args:
            pred_ids: (B, L) left-packed collapsed token ids.
            pred_counts: (B,) valid counts per row.
            targets: (B, L) padded target ids (0 = pad/blank).
        """
        pred_ids = np.asarray(pred_ids)
        pred_counts = np.asarray(pred_counts)
        tgt = np.asarray(targets)
        preds_str, targets_str = [], []
        for i in range(pred_ids.shape[0]):
            ids = pred_ids[i, :int(pred_counts[i])].tolist()
            preds_str.append(self.tokenizer.decode(ids))
            t_ids = [int(x) for x in tgt[i] if int(x) != 0]
            targets_str.append(self.tokenizer.decode(t_ids))
        try:
            w = wer(targets_str, preds_str)
            c = cer(targets_str, preds_str)
        except Exception:  # noqa: BLE001
            w, c = 1.0, 1.0
        return {"wer": w, "cer": c}, preds_str, targets_str

    def compute(self, predictions, targets, input_lengths=None):
        """
        Args:
            predictions: (B, T, V) logits (numpy or jax array).
            targets: (B, L) padded target ids.
            input_lengths: optional (B,) valid output frames.

        Returns:
            ({"wer": float, "cer": float}, preds_str, targets_str)
        """
        logits = np.asarray(predictions)
        tgt = np.asarray(targets)
        pred_ids = np.argmax(logits, axis=2)

        preds_str, targets_str = [], []
        for i in range(pred_ids.shape[0]):
            p_ids = pred_ids[i]
            if input_lengths is not None:
                p_ids = p_ids[: int(np.asarray(input_lengths)[i])]
            preds_str.append(self.tokenizer.ctc_decode(p_ids.tolist()))
            t_ids = [int(x) for x in tgt[i] if int(x) != 0]
            targets_str.append(self.tokenizer.decode(t_ids))

        try:
            w = wer(targets_str, preds_str)
            c = cer(targets_str, preds_str)
        except Exception:  # noqa: BLE001 — parity with reference fallback
            w, c = 1.0, 1.0
        return {"wer": w, "cer": c}, preds_str, targets_str
