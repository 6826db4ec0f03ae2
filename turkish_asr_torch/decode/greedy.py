"""Greedy CTC decoding: argmax and collapse on the device.

Counterpart of turkish_asr_tpu/decode/greedy.py. The whole batch collapse
(drop repeats, drop blanks, left-pack) is tensor code on the logits'
device; the host only detokenizes the packed id rows. The span
``d2h_wait`` (``utils/tracing.py``) covers the host's wait for them.
"""

import torch

from turkish_asr_torch.utils import tracing


def greedy_collapse_batch(logits, lengths=None, *, blank_id=0):
    """Argmax -> CTC collapse -> left-packed ids.

    Args:
        logits: (B, T, V) logits or log-probs.
        lengths: optional (B,) valid frame counts.

    Returns:
        (ids (B, T) int32 left-packed with -1 padding, counts (B,) int32).
    """
    pred = logits.argmax(dim=-1).to(torch.int32)
    B, T = pred.shape
    prev = torch.nn.functional.pad(pred, (1, 0), value=-1)[:, :T]
    keep = (pred != prev) & (pred != blank_id)
    if lengths is not None:
        frames = torch.arange(T, device=pred.device)[None, :]
        keep &= frames < lengths.to(pred.device)[:, None]
    counts = keep.sum(dim=1).to(torch.int32)
    # Kept ids go to cumsum(keep) - 1; dropped ones to an overflow column.
    pos = torch.cumsum(keep, dim=1) - 1
    scatter_pos = torch.where(keep, pos, T).to(torch.int64)
    out = torch.full((B, T + 1), -1, dtype=torch.int32, device=pred.device)
    out.scatter_(1, scatter_pos, torch.where(keep, pred, -1))
    return out[:, :T], counts


class GreedyDecoder:
    """Tokenizer-aware greedy decoder (reference-compatible API)."""

    def __init__(self, tokenizer, blank_id=0):
        self.tokenizer = tokenizer
        self.blank_id = blank_id

    def decode(self, logits):
        """(T, V) -> text."""
        return self.tokenizer.ctc_decode(torch.as_tensor(logits).argmax(dim=-1).tolist())

    def decode_batch(self, logits, lengths=None):
        """(B, T, V) -> list of texts (device collapse, host detokenize)."""
        blank = getattr(self.tokenizer, "pad_token_id", None)
        if blank is None:
            blank = self.blank_id
        ids, counts = greedy_collapse_batch(logits, lengths, blank_id=int(blank))
        with tracing.span("d2h_wait"):
            ids, counts = ids.cpu().tolist(), counts.cpu().tolist()
        return [self.tokenizer.decode(row[:n]) for row, n in zip(ids, counts)]
