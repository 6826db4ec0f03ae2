"""BPE tokenizer training side-tool: ``python -m turkish_asr_torch.spm_train``.

Counterpart of spm_train.py (the JAX package's; the reference's trains a
SentencePiece BPE over all transcript ``.txt`` files, pad_id=0 reserved as
the CTC blank, unk_id=1, no bos/eos). sentencepiece is not a dependency:
training uses the port's self-contained BPE (``data/bpe.py``) and saves
``tokenizer_bpe.json`` in the working directory, the same file the JAX
script writes (``tests/test_torch_spm_train.py``), loadable by
``BPETokenizer.load`` and by ``data.tokenizer.load_tokenizer`` (the
trainer's ``--tokenizer_path``).

Flags are the training CLI's (``utils/config.py``); it reads
``--data_path`` and ``--vocab_size``.
"""

import glob
import os

from turkish_asr_torch.data.bpe import BPETokenizer, train_bpe
from turkish_asr_torch.utils.config import get_config

OUT_PATH = "tokenizer_bpe.json"


def train_tokenizer(argv=None):
    """Train on every ``.txt`` under ``--data_path`` and write
    ``tokenizer_bpe.json``; returns its path, or None when there is no
    transcript."""
    config = get_config(argv)
    data_path = config.data_path
    vocab_size = config.vocab_size

    print(f"Data path: {data_path}")
    print(f"Target vocab size: {vocab_size}")

    txt_files = glob.glob(os.path.join(data_path, "**", "*.txt"), recursive=True)
    if not txt_files:
        print("ERROR: no .txt files found!")
        return None

    print(f"Found {len(txt_files)} transcript files. Training BPE...")
    texts = []
    for fpath in txt_files:
        with open(fpath, "r", encoding="utf-8") as f:
            texts.append(f.read().strip())

    vocab, merges = train_bpe(texts, vocab_size=vocab_size)
    tok = BPETokenizer(vocab, merges)
    tok.save(OUT_PATH)
    print(f"Training done! Vocab size: {tok.vocab_size}. Saved: {OUT_PATH}")
    return OUT_PATH


if __name__ == "__main__":
    train_tokenizer()
