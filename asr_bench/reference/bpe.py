"""The byte-pair vocabulary of the benchmark's configurations, and its
plain encoder and decoder.

Frozen copies of ``turkish_asr_torch/data/bpe.py`` (``train_bpe`` :24-67,
``BPETokenizer._encode_word``, ``encode``, ``decode`` :88-115) and of the
collapse of ``turkish_asr_torch/data/tokenizer.py::_ctc_collapse``
(:72-84), which follow the reference's side tool ``spm_train.py``: id 0
the blank and pad, id 1 <unk>, then the corpus's characters, then merged
symbols, each word marked by a leading "▁".

The vocabulary file a configuration names (its ``vocabulary``,
``asr_bench/vocab/<config>.json``) is made once, by

    python -m asr_bench.reference.bpe --config flagship

from words of random Turkish letters as ``asr_bench/traffic.py`` makes
transcripts, drawn from a fixed seed; the program loads the same file as
its tokenizer (``tokenizer_path``), and this module reads it for the
reference.
"""

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np

WORD_MARK = "▁"
BLANK, UNK = 0, 1
ROOT = Path(__file__).resolve().parents[2]


def train(texts, vocab_size):
    """(vocab, merges) of a byte-pair vocabulary of ``texts``."""
    words = Counter()
    for line in texts:
        for w in line.strip().lower().split():
            words[WORD_MARK + w] += 1
    corpus = {tuple(w): c for w, c in words.items()}
    vocab = ["<blank>", "<unk>"] + sorted({ch for w in corpus for ch in w})
    merges = []
    while len(vocab) < vocab_size:
        pairs = Counter()
        for seq, cnt in corpus.items():
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += cnt
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append([a, b])
        vocab.append(a + b)
        new = {}
        for seq, c in corpus.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new[tuple(out)] = c
        corpus = new
    return vocab, merges


class Vocabulary:
    """A vocabulary file read for the reference: ``encode`` (text to ids)
    and ``decode`` (collapsed ids to text)."""

    def __init__(self, vocab, merges):
        self.strings = list(vocab)
        self.index = {s: i for i, s in enumerate(self.strings)}
        self.rank = {tuple(m): r for r, m in enumerate(merges)}

    @classmethod
    def of(cls, cfg):
        """The vocabulary file that configuration ``cfg`` names."""
        with open(ROOT / cfg["vocabulary"], encoding="utf-8") as f:
            blob = json.load(f)
        return cls(blob["vocab"], blob["merges"])

    def __len__(self):
        return len(self.strings)

    def _word(self, word):
        syms = list(word)
        while len(syms) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self.rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        return [self.index.get(s, UNK) for s in syms]

    def encode(self, text):
        ids = []
        for w in text.strip().lower().split():
            ids.extend(self._word(WORD_MARK + w))
        return ids

    def decode(self, ids):
        return "".join(self.strings[i] for i in ids if i not in (BLANK, UNK)).replace(
            WORD_MARK, " ").strip()

    def greedy_text(self, logits):
        """The greedy transcript of (T, V) logits: argmax, each run of a
        label kept once, blank and <unk> dropped."""
        out, prev = [], -1
        for i in np.asarray(logits).argmax(axis=1).tolist():
            if i != prev:
                out.append(i)
            prev = i
        return self.decode(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Write a configuration's vocabulary file.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--words", type=int, default=60000)
    args = parser.parse_args(argv)
    from asr_bench import common, traffic

    cfg = common.load_json("configs", args.config)
    rng = traffic.rng_of(cfg["vocabulary_seed"], 0)
    texts = [traffic.transcript(16000, 40, rng) for _ in range(args.words // 6)]
    vocab, merges = train(texts, cfg["n_classes"])
    if len(vocab) != cfg["n_classes"]:
        raise SystemExit(f"the corpus gave {len(vocab)} symbols, not {cfg['n_classes']}")
    path = ROOT / cfg["vocabulary"]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"vocab": vocab, "merges": merges}, f, ensure_ascii=False)
    print(f"{path}: {len(vocab)} symbols, {len(merges)} merges")


if __name__ == "__main__":
    main()
