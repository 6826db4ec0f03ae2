"""Shared inputs of the port's beam-search tests: the small ARPAs of the
JAX package's fusion tests and a word tokenizer."""

# Word ARPA of tests/test_trie_fusion.py: its words are spelt by the char
# tokenizer, and "o" is a one-char word, so the hash form's dedup keeps
# K2 = 2 distinct word ids.
WORD_ARPA = """\
\\data\\
ngram 1=8
ngram 2=8
ngram 3=3

\\1-grams:
-1.0\t<unk>\t-0.30
-0.8\t<s>\t-0.40
-0.9\t</s>
-0.5\tbir\t-0.20
-0.6\tiki\t-0.25
-0.7\tbin\t-0.10
-1.1\tev\t-0.15
-1.2\to

\\2-grams:
-0.2\t<s> bir\t-0.10
-0.4\t<s> iki
-0.3\tbir iki\t-0.15
-0.5\tbir ev
-0.25\tiki bin\t-0.05
-0.6\tiki o
-0.45\tev bir
-0.7\to ev

\\3-grams:
-0.1\t<s> bir iki
-0.2\tbir iki bin
-0.3\tiki bin o

\\end\\
"""

# Token ARPA of tests/test_arpa_fusion.py, over a word tokenizer whose
# tokens past "d" are no ARPA word (<unk>).
TOKEN_ARPA = WORD_ARPA.replace("bir", "a").replace("iki", "b").replace(
    "bin", "c").replace("ev", "d")
WORDS = ["<pad>", "a", "b", "c", "d", "o", "e", "f", "g", "h", "i", "j"]


class WordTok:
    """Each token one word; decode joins with spaces."""

    vocab_size = len(WORDS)

    def encode(self, text):
        return [WORDS.index(w) for w in text.split()]

    def decode(self, ids):
        return " ".join(WORDS[i] for i in ids)
