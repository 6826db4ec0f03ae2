"""Decoder factory: "greedy", "beam" (host) and "flashlight" (the device beam).

Counterpart of turkish_asr_tpu/decode/factory.py. The reference's
"flashlight" method is its native high-performance decoder; here that slot
is the batched prefix beam search of ops/beam_search.py, on the card. No
flashlight-text package is imported or probed for.
"""

import os

import numpy as np
import torch

from turkish_asr_torch.decode.beam import CTCBeamDecoder
from turkish_asr_torch.decode.greedy import GreedyDecoder
from turkish_asr_torch.decode.lm import KenLMModel
from turkish_asr_torch.utils.device import resolve_device


class DeviceBeamDecoder:
    """Batched beam search on ``device`` behind the decoder API.

    Optional LM shallow fusion in one of four forms (decode/lm.py builds
    them): ``lm_bias`` (V+1, V) token bigrams, ``lm_tables`` (score,
    next_state, start_state) ARPA state tables for word tokenizers,
    ``lm_trie`` for char/subword tokenizers, ``lm_hash`` for ARPAs too
    large for the dense trie tables. The tables become device tensors once,
    here. The final per-word bonus (the reference's beta) reranks all W
    beams on the host.
    """

    def __init__(self, tokenizer, beam_width=16, blank_id=0, lm_bias=None, lm_weight=0.3,
                 lm_tables=None, lm_trie=None, lm_hash=None, word_bonus=0.5, device="cuda"):
        from turkish_asr_torch.ops.beam_search import prepare_lm
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.blank_id = blank_id
        self.lm_weight = lm_weight
        self.word_bonus = word_bonus
        self.device = resolve_device(device)
        start = 0
        if lm_tables is not None:
            start = int(lm_tables[2])
            lm_tables = lm_tables[:2]
        if lm_trie is not None:
            if "pnext" not in lm_trie:  # dicts built before the fused advance
                from turkish_asr_torch.decode.lm import derive_fused_trie_advance
                pnext, wq = derive_fused_trie_advance(
                    lm_trie["ptrans"], lm_trie["wid"], lm_trie["tok_kind"])
                lm_trie = dict(lm_trie, pnext=pnext, wq=wq)
            start = int(lm_trie["start_h"])
        mode, lm = prepare_lm(self.device, lm_bias=lm_bias, lm_tables=lm_tables,
                              lm_trie=lm_trie, lm_hash=lm_hash)
        self._lm_kwargs = {}
        if mode is not None:
            tables = lm
            if mode == "bias":
                tables = lm["bias"]
            elif mode == "tables":
                tables = (lm["score"], lm["next"])
            self._lm_kwargs = {f"lm_{mode}": tables, "lm_start_state": start,
                               "lm_weight": lm_weight}

    def decode(self, logits, length=None):
        return self.decode_batch(torch.as_tensor(logits)[None],
                                 None if length is None else [length])[0]

    def decode_batch(self, logits, lengths=None):
        """(B, T, V) logits or log-probs (a tensor on any device, or numpy)
        -> texts. log_softmax is idempotent, so either is accepted."""
        from turkish_asr_torch.ops.beam_search import ctc_beam_search
        x = torch.as_tensor(logits).to(self.device, torch.float32).log_softmax(dim=-1)
        lens = None if lengths is None else torch.as_tensor(lengths).to(self.device)
        kwargs = dict(self._lm_kwargs)
        # The id rows past 512 are dropped: transcripts are far shorter
        # than T, and the cap only bounds the backtrace's output.
        kwargs["max_prefix_len"] = min(x.shape[1], 512)
        if self.word_bonus != 0:
            ids, counts, scores = ctc_beam_search(
                x, lens, beam_width=self.beam_width, blank_id=self.blank_id,
                return_all_beams=True, **kwargs)
            ids, counts, scores = ids.cpu().numpy(), counts.cpu().numpy(), scores.cpu().numpy()
            out = []
            for i in range(ids.shape[0]):
                best_text, best_score = "", -np.inf
                for w in range(ids.shape[1]):
                    if scores[i, w] <= -1e29:
                        continue  # dead beam
                    text = self.tokenizer.decode(ids[i, w, :counts[i, w]].tolist())
                    s = scores[i, w] + self.word_bonus * len(text.split())
                    if s > best_score:  # strict: the first beam wins a tie
                        best_score, best_text = s, text
                out.append(best_text)
            return out
        ids, counts = ctc_beam_search(x, lens, beam_width=self.beam_width,
                                      blank_id=self.blank_id, **kwargs)
        ids, counts = ids.cpu().numpy(), counts.cpu().numpy()
        return [self.tokenizer.decode(ids[i, :counts[i]].tolist()) for i in range(ids.shape[0])]


class FlashlightDecoder:
    """The reference's FlashlightDecoder slot (its native C++ decoder):
    the device beam, LM-fused when the LM compiles into tables, the host
    beam only when no table form can model the tokenizer."""

    def __init__(self, tokenizer, lexicon_path=None, lm_path=None, beam_size=100,
                 lm_weight=2.0, word_score=-1.0, sil_score=0.0, beam_threshold=25.0,
                 device="cuda"):
        self.tokenizer = tokenizer
        lm = None
        if lm_path and os.path.exists(lm_path):
            try:
                lm = KenLMModel(lm_path)
            except Exception as e:  # noqa: BLE001 — e.g. a binary .klm without kenlm
                print(f"Warning: Could not load LM: {e}")
        width = min(beam_size, 32)
        if lm is None:
            self._impl = DeviceBeamDecoder(tokenizer, beam_width=width, word_bonus=word_score,
                                           device=device)
            return
        tables = trie = lm_ht = None
        vocab = getattr(tokenizer, "vocab_size", None)
        if vocab:
            from turkish_asr_torch.decode.lm import (
                build_arpa_fusion_tables, build_hash_fusion_tables, build_trie_fusion_tables,
                tokenizer_is_word_granular)
            if tokenizer_is_word_granular(tokenizer, vocab):
                tables = build_arpa_fusion_tables(lm, tokenizer, vocab)
            if tables is None:
                trie = build_trie_fusion_tables(lm, tokenizer, vocab)
            if tables is None and trie is None:
                lm_ht = build_hash_fusion_tables(lm, tokenizer, vocab)
        if trie is None and lm_ht is None and tables is None:
            self._impl = CTCBeamDecoder(tokenizer, beam_width=beam_size, lm=lm,
                                        lm_weight=lm_weight)
        else:
            # word_score (the reference's -1.0, an insertion penalty) is
            # the device beam's per-word rerank term.
            self._impl = DeviceBeamDecoder(tokenizer, beam_width=width, lm_tables=tables,
                                           lm_trie=trie, lm_hash=lm_ht, lm_weight=lm_weight,
                                           word_bonus=word_score, device=device)

    def decode(self, logits, length=None):
        return self._impl.decode(logits, length)

    def decode_batch(self, logits, lengths=None):
        return self._impl.decode_batch(logits, lengths)


def create_decoder(tokenizer, method="greedy", lm_path=None, beam_width=10, lm_weight=0.3,
                   device="cuda"):
    """"greedy", "beam" (host prefix beam, optional LM fusion) or
    "flashlight" (the device beam)."""
    lm = None
    if lm_path and os.path.exists(lm_path):
        try:
            lm = KenLMModel(lm_path)
        except Exception as e:  # noqa: BLE001 — as the reference
            print(f"Warning: Could not load LM: {e}")
    if method == "greedy":
        return GreedyDecoder(tokenizer)
    if method == "beam":
        return CTCBeamDecoder(tokenizer, beam_width=beam_width, lm=lm, lm_weight=lm_weight)
    if method == "flashlight":
        return FlashlightDecoder(tokenizer, lm_path=lm_path, beam_size=beam_width,
                                 lm_weight=lm_weight, device=device)
    raise ValueError(f"Unknown decoder method: {method}")
