"""``python -m turkish_asr_torch.spm_train`` against the JAX package's
``spm_train.py``: on the same corpus both write the same
``tokenizer_bpe.json``, byte for byte, and the port's tokenizer factory
loads it."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TEXTS = {"a/s0.txt": "merhaba dünya bir iki üç", "a/s1.txt": "bir iki bir iki evet hayır",
         "b/c/s2.txt": "güneş deniz kitap merhaba", "s3.txt": "dört beş altı yedi sekiz"}


@pytest.fixture
def corpus(tmp_path):
    root = tmp_path / "corpus"
    for rel, text in TEXTS.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text + "\n", encoding="utf-8")
    return root


def test_port_writes_the_jax_scripts_tokenizer(corpus, tmp_path, monkeypatch, capsys):
    import spm_train
    from turkish_asr_torch import spm_train as port_spm
    from turkish_asr_torch.data.tokenizer import load_tokenizer
    flags = ["--data_path", str(corpus), "--vocab_size", "90"]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["spm_train.py", *flags])
            spm_train.train_tokenizer()
        else:
            assert port_spm.train_tokenizer(flags) == "tokenizer_bpe.json"
    out = capsys.readouterr().out
    assert out.count("Found 4 transcript files") == 2
    want = (tmp_path / "jax" / "tokenizer_bpe.json").read_bytes()
    assert (tmp_path / "port" / "tokenizer_bpe.json").read_bytes() == want
    tok = load_tokenizer(str(tmp_path / "port" / "tokenizer_bpe.json"))
    assert type(tok).__name__ == "BPETokenizer" and tok.vocab_size > 40
    assert tok.decode(tok.encode("merhaba dünya")) == "merhaba dünya"


def test_no_transcripts_writes_nothing(tmp_path, monkeypatch, capsys):
    from turkish_asr_torch import spm_train as port_spm
    monkeypatch.chdir(tmp_path)
    assert port_spm.train_tokenizer(["--data_path", str(tmp_path)]) is None
    assert "ERROR: no .txt files found!" in capsys.readouterr().out
    assert not (tmp_path / "tokenizer_bpe.json").exists()
