"""Synthetic ARPA files for the beam-search measurements.

``synthetic_word_arpa`` is copied from ``bench.py::_synthetic_word_arpa``
(bench.py imports JAX, so the port and chip_smoke.py keep their own copy);
the body is unchanged and the file it writes is byte-identical
(tests/test_torch_lm_fusion.py). Two sizes are used:

- ``n_words=400, seed=0``: bench config 4's LM, a word ARPA fused through
  the default char tokenizer (the trie tables);
- ``n_words=100_000, seed=7, ngram_counts={2: 500_000, 3: 300_000,
  4: 150_000}``: its production-scale variant, an order-4 ARPA too large
  for the dense tables (the hash tables).

``synthetic_token_arpa`` is copied from ``bench.py::_synthetic_arpa``
(:226-256), body unchanged, byte-identical output
(tests/test_torch_bench.py): a char-level trigram ARPA over a tokenizer's
vocabulary, the LM of bench config 4's word-granular state tables.

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


def synthetic_token_arpa(tokenizer, path):
    """Char-level trigram ARPA over the tokenizer's vocab (synthetic —
    the image ships no Turkish corpus; table shapes/costs are identical)."""
    rng = np.random.default_rng(0)
    toks = [tokenizer.decode([v]).strip() or f"tk{v}"
            for v in range(2, min(tokenizer.vocab_size, 40))]
    uni = [(t, float(-1 - rng.random())) for t in toks]
    # Dedup BEFORE the header: strict ARPA consumers (kenlm tools) reject
    # files whose \data\ counts overstate the body.
    bi, tri = {}, {}
    for _ in range(400):
        a, b = rng.choice(toks, 2)
        bi[(a, b)] = float(-rng.random())
    for _ in range(600):
        a, b, c = rng.choice(toks, 3)
        tri[(a, b, c)] = float(-rng.random())
    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(uni) + 3}\nngram 2={len(bi)}\n"
                f"ngram 3={len(tri)}\n\n\\1-grams:\n")
        f.write("-1.5\t<unk>\t-0.3\n-1.0\t<s>\t-0.4\n-1.2\t</s>\n")
        for t, lp in uni:
            f.write(f"{lp:.4f}\t{t}\t-0.3\n")
        f.write("\n\\2-grams:\n")
        for (a, b), lp in bi.items():
            f.write(f"{lp:.4f}\t{a} {b}\t-0.2\n")
        f.write("\n\\3-grams:\n")
        for (a, b, c), lp in tri.items():
            f.write(f"{lp:.4f}\t{a} {b} {c}\n")
        f.write("\n\\end\\\n")


if __name__ == "__main__":
    synthetic_word_arpa(sys.argv[1], *(int(a) for a in sys.argv[2:4]))
