# Copied from turkish_asr_tpu/data/bpe.py; only the imports and the form of the
# reference-file citations differ. The JAX package's own __init__ files
# import JAX, so this jax-free host module cannot be imported from there.
"""Self-contained BPE tokenizer training + inference.

The reference's side tool trains a SentencePiece BPE model
(reference spm_train.py: vocab with pad_id=0 as the CTC blank,
unk_id=1, no bos/eos, character_coverage=1.0). sentencepiece is not a
dependency here; this module implements classic byte-pair-encoding merge
training over whitespace-marked words (SentencePiece-style "▁" word
boundary marker) and a greedy longest-merge encoder, saved as a JSON vocab.

The resulting BPETokenizer satisfies the same tokenizer protocol as
CharTokenizer (encode/decode/ctc_decode, pad_token_id == 0 == blank) and
can be plugged into training via TurkishTokenizer-compatible duck typing.
"""

import json
from collections import Counter

WORD_MARK = "▁"  # ▁


def train_bpe(texts, vocab_size=1000):
    """Train BPE merges; returns (vocab list, merges list).

    id 0 = <blank>/pad, id 1 = <unk>; then single characters (full
    coverage), then merged symbols until vocab_size.
    """
    words = Counter()
    for line in texts:
        for w in line.strip().lower().split():
            words[WORD_MARK + w] += 1

    # Start from character symbols.
    corpus = {tuple(w): c for w, c in words.items()}
    charset = sorted({ch for w in corpus for ch in w})
    vocab = ["<blank>", "<unk>"] + charset
    merges = []

    while len(vocab) < vocab_size:
        pairs = Counter()
        for sym_seq, cnt in corpus.items():
            for a, b in zip(sym_seq, sym_seq[1:]):
                pairs[(a, b)] += cnt
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        new_sym = a + b
        merges.append([a, b])
        vocab.append(new_sym)
        new_corpus = {}
        for sym_seq, c in corpus.items():
            out = []
            i = 0
            while i < len(sym_seq):
                if i + 1 < len(sym_seq) and sym_seq[i] == a and sym_seq[i + 1] == b:
                    out.append(new_sym)
                    i += 2
                else:
                    out.append(sym_seq[i])
                    i += 1
            new_corpus[tuple(out)] = c
        corpus = new_corpus
    return vocab, merges


class BPETokenizer:
    """BPE tokenizer over a trained vocab (blank=0 contract)."""

    def __init__(self, vocab, merges):
        self._itos = list(vocab)
        self._stoi = {s: i for i, s in enumerate(self._itos)}
        self._merge_rank = {tuple(m): r for r, m in enumerate(merges)}
        self.pad_token_id = 0
        self.unk_token_id = 1

    @property
    def vocab_size(self):
        return len(self._itos)

    @property
    def chars(self):
        return range(self.vocab_size)

    def _encode_word(self, word):
        syms = list(word)
        while len(syms) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self._merge_rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        return [self._stoi.get(s, self.unk_token_id) for s in syms]

    def encode(self, text):
        ids = []
        for w in text.strip().lower().split():
            ids.extend(self._encode_word(WORD_MARK + w))
        return ids

    def decode(self, ids):
        toks = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.unk_token_id):
                continue
            if 0 <= i < len(self._itos):
                toks.append(self._itos[i])
        return "".join(toks).replace(WORD_MARK, " ").strip()

    def ctc_decode(self, ids):
        from turkish_asr_torch.data.tokenizer import _ctc_collapse
        return self.decode(_ctc_collapse(ids, self.pad_token_id))

    # -- persistence --------------------------------------------------------
    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"vocab": self._itos,
                       "merges": [list(m) for m in sorted(
                           self._merge_rank, key=self._merge_rank.get)]},
                      f, ensure_ascii=False)

    @classmethod
    def load(cls, path):
        with open(path, "r", encoding="utf-8") as f:
            blob = json.load(f)
        return cls(blob["vocab"], blob["merges"])
