# Copied from turkish_asr_tpu/decode/beam.py; the host decoder is unchanged apart
# from the form of the reference-file citations and its lazy import of the
# port's own decode/lm.py. beam_search_batch re-exports the port's search.
"""CTC prefix beam search with optional LM shallow fusion.

Semantics match the reference CTCBeamDecoder
(reference utils/decoding.py:172-307): beam state maps prefix ->
(log P ending in blank, log P ending in non-blank); per step only the
top-(2*beam_width) tokens are expanded; LM score (weight alpha) is added on
prefix extension; a word-count bonus (beta) is applied at the end.

Two implementations:
- :class:`CTCBeamDecoder` — host reference implementation (numpy), used for
  LM fusion with arbitrary host-side LMs and as the oracle for tests.
- :func:`beam_search_batch` — batched fixed-width beam search in torch
  (see ops/beam_search.py) on the tensors' device; imported lazily.
"""

import math

import numpy as np


def _lse(a, b):
    """log(exp(a) + exp(b)), -inf-safe."""
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


class CTCBeamDecoder:
    """Prefix beam search over (T, V) probabilities.

    Args:
        tokenizer: used for final detokenization and KenLM context.
        beam_width: beams kept per step.
        lm: optional KenLMModel/ArpaLanguageModel/NGramLanguageModel.
        lm_weight: shallow-fusion weight (alpha).
        word_bonus: per-word insertion bonus applied at the end (beta).
        blank_id: CTC blank.
    """

    def __init__(self, tokenizer, beam_width=10, lm=None, lm_weight=0.3,
                 word_bonus=0.5, blank_id=0):
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.lm = lm
        self.lm_weight = lm_weight
        self.word_bonus = word_bonus
        self.blank_id = blank_id

    # -- LM dispatch ------------------------------------------------------
    def _lm_score(self, prefix, token_id):
        from turkish_asr_torch.decode.lm import (
            KenLMModel, ArpaLanguageModel, NGramLanguageModel)
        if isinstance(self.lm, (KenLMModel, ArpaLanguageModel)):
            context = self.tokenizer.decode(list(prefix)) if prefix else ""
            next_text = self.tokenizer.decode([token_id])
            return self.lm.score_word(next_text, context)
        if isinstance(self.lm, NGramLanguageModel):
            return self.lm.score(prefix, token_id)
        return 0.0

    # -- core -------------------------------------------------------------
    def decode_ids(self, logits, length=None):
        """(T, V) logits -> best prefix tuple of token ids."""
        x = np.asarray(logits, dtype=np.float64)
        if length is not None:
            x = x[: int(length)]
        # softmax -> log(p + 1e-10), like the reference's log of probs.
        x = x - x.max(axis=-1, keepdims=True)
        probs = np.exp(x)
        probs /= probs.sum(axis=-1, keepdims=True)
        logp = np.log(probs + 1e-10)

        T, V = logp.shape
        k = min(V, self.beam_width * 2)
        beam = {(): (0.0, -math.inf)}

        for t in range(T):
            top = np.argpartition(-logp[t], k - 1)[:k]
            nxt = {}

            def upd(prefix, db=None, dnb=None):
                pb, pnb = nxt.get(prefix, (-math.inf, -math.inf))
                if db is not None:
                    pb = _lse(pb, db)
                if dnb is not None:
                    pnb = _lse(pnb, dnb)
                nxt[prefix] = (pb, pnb)

            for prefix, (p_b, p_nb) in beam.items():
                total = _lse(p_b, p_nb)
                for tok in top:
                    tok = int(tok)
                    pt = float(logp[t, tok])
                    if tok == self.blank_id:
                        upd(prefix, db=total + pt)
                    elif prefix and prefix[-1] == tok:
                        # extend only through a blank transition
                        upd(prefix + (tok,), dnb=p_b + pt)
                        # same-token merge stays on the prefix
                        upd(prefix, dnb=p_nb + pt)
                    else:
                        score = total + pt
                        if self.lm is not None:
                            score += self.lm_weight * self._lm_score(prefix, tok)
                        upd(prefix + (tok,), dnb=score)

            ranked = sorted(nxt.items(), key=lambda kv: _lse(*kv[1]), reverse=True)
            beam = dict(ranked[: self.beam_width])

        best_prefix, best_score = None, -math.inf
        for prefix, (p_b, p_nb) in beam.items():
            score = _lse(p_b, p_nb)
            if self.word_bonus > 0:
                text = self.tokenizer.decode(list(prefix))
                score += self.word_bonus * len(text.split())
            if score > best_score:
                best_score, best_prefix = score, prefix
        return best_prefix or ()

    def decode(self, logits, length=None):
        """(T, V) -> text."""
        return self.tokenizer.decode(list(self.decode_ids(logits, length)))

    def decode_batch(self, logits, lengths=None):
        """(B, T, V) -> list of texts."""
        x = np.asarray(logits)
        out = []
        for i in range(x.shape[0]):
            n = None if lengths is None else int(np.asarray(lengths)[i])
            out.append(self.decode(x[i], n))
        return out


def beam_search_batch(log_probs, lengths=None, *, beam_width=16, blank_id=0):
    """Batched CTC prefix beam search on the tensors' device (no LM fusion).

    Thin re-export of ops/beam_search.py, so decode/ is the import surface.
    """
    from turkish_asr_torch.ops.beam_search import ctc_beam_search
    return ctc_beam_search(log_probs, lengths, beam_width=beam_width,
                           blank_id=blank_id)
