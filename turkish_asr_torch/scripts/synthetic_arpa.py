"""Synthetic word-level ARPA files for the beam-search measurements.

Copied from ``bench.py::_synthetic_word_arpa`` (bench.py imports JAX, so
the port and chip_smoke.py keep their own copy); the body is unchanged and
the file it writes is byte-identical (tests/test_torch_lm_fusion.py). Two
sizes are used:

- ``n_words=400, seed=0``: bench config 4's LM, a word ARPA fused through
  the default char tokenizer (the trie tables);
- ``n_words=100_000, seed=7, ngram_counts={2: 500_000, 3: 300_000,
  4: 150_000}``: its production-scale variant, an order-4 ARPA too large
  for the dense tables (the hash tables).

Usage: ``python -m turkish_asr_torch.scripts.synthetic_arpa OUT.arpa
[N_WORDS] [SEED]``.
"""

import sys

import numpy as np

PRODUCTION = dict(n_words=100_000, seed=7, ngram_counts={2: 500_000, 3: 300_000, 4: 150_000})


def synthetic_word_arpa(path, n_words=400, seed=0, ngram_counts=None):
    """WORD-level ARPA over synthetic Turkish-like words — the realistic
    config-4 shape: a word LM fused through the default CHAR tokenizer.
    ngram_counts maps order -> how many n-grams to sample (default
    {2: 5*n_words, 3: 3*n_words}); orders beyond the max get no backoff
    column. Generation is vectorized (index sampling + np.unique dedup)
    so 100k-word / million-n-gram LMs build in seconds."""
    rng = np.random.default_rng(seed)
    chars = np.array(list("abcçdefgğhıijklmnoöprsştuüvyz"))
    words = set()
    while len(words) < n_words:
        need = n_words - len(words)
        lens = rng.integers(2, 9, need)
        flat = rng.choice(chars, int(lens.sum()))
        off = 0
        for L in lens:
            words.add("".join(flat[off:off + L]))
            off += L
    words = sorted(words)
    warr = np.array(words)
    if ngram_counts is None:
        ngram_counts = {2: n_words * 5, 3: n_words * 3}
    max_order = max(ngram_counts)
    sections = {}
    for order, count in sorted(ngram_counts.items()):
        idx = np.unique(rng.integers(0, n_words, (count, order)), axis=0)
        sections[order] = (idx, -rng.random(len(idx)))
    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={n_words + 3}\n")
        for order, (idx, _) in sorted(sections.items()):
            f.write(f"ngram {order}={len(idx)}\n")
        f.write("\n\\1-grams:\n")
        f.write("-1.5\t<unk>\t-0.3\n-1.0\t<s>\t-0.4\n-1.2\t</s>\n")
        for w, lp in zip(words, -1 - 2 * rng.random(n_words)):
            f.write(f"{lp:.4f}\t{w}\t-0.3\n")
        for order, (idx, lps) in sorted(sections.items()):
            f.write(f"\n\\{order}-grams:\n")
            has_bo = order < max_order
            for row, lp in zip(idx, lps):
                gram = " ".join(warr[row])
                if has_bo:
                    f.write(f"{lp:.4f}\t{gram}\t-0.2\n")
                else:
                    f.write(f"{lp:.4f}\t{gram}\n")
        f.write("\n\\end\\\n")


if __name__ == "__main__":
    synthetic_word_arpa(sys.argv[1], *(int(a) for a in sys.argv[2:4]))
