"""The port's LM-fusion builders and decoders against the JAX package's.

``turkish_asr_torch/decode/lm.py`` is a copy of the JAX package's numpy
builders: on the same ARPA and tokenizer they must give np.array_equal
arrays, the same ints and the same ``tokenizer_is_word_granular``, since
the arrays decide both the scores and which fusion form "auto" picks. The
host ``CTCBeamDecoder`` and the ``DeviceBeamDecoder`` (here on the CPU)
must give the JAX decoders' texts. ``scripts/synthetic_arpa.py`` must write
the bytes ``bench._synthetic_word_arpa`` writes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from turkish_asr_tpu.data import bpe as jax_bpe  # noqa: E402
from turkish_asr_tpu.data.tokenizer import TurkishTokenizer as JaxTok  # noqa: E402
from turkish_asr_tpu.decode import beam as jax_beam  # noqa: E402
from turkish_asr_tpu.decode import factory as jax_factory  # noqa: E402
from turkish_asr_tpu.decode import lm as jax_lm  # noqa: E402
from turkish_asr_torch.data import bpe as port_bpe  # noqa: E402
from turkish_asr_torch.data.tokenizer import TurkishTokenizer as PortTok  # noqa: E402
from turkish_asr_torch.decode import beam as port_beam  # noqa: E402
from turkish_asr_torch.decode import factory as port_factory  # noqa: E402
from turkish_asr_torch.decode import lm as port_lm  # noqa: E402
from turkish_asr_torch.scripts.synthetic_arpa import synthetic_word_arpa  # noqa: E402
from beam_fixtures import TOKEN_ARPA, WORD_ARPA, WordTok  # noqa: E402

BPE_TEXTS = ["bir iki bin ev o bir iki", "iki bin o ev bir bin iki"]
WORD_TEXTS = ["a b c a", "b c d o e"]


def _same(a, b, where="tables"):
    """Equal in type, shape, dtype and value, all the way down."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    paths = {"words": d / "words.arpa", "tokens": d / "tokens.arpa", "w400": d / "w400.arpa"}
    paths["words"].write_text(WORD_ARPA)
    paths["tokens"].write_text(TOKEN_ARPA)
    synthetic_word_arpa(str(paths["w400"]))
    return {k: str(v) for k, v in paths.items()}


def _tokenizers(kind):
    if kind == "char":
        return JaxTok(), PortTok()
    if kind == "word":
        return WordTok(), WordTok()
    vocab, merges = jax_bpe.train_bpe(BPE_TEXTS, vocab_size=48)
    pvocab, pmerges = port_bpe.train_bpe(BPE_TEXTS, vocab_size=48)
    return jax_bpe.BPETokenizer(vocab, merges), port_bpe.BPETokenizer(pvocab, pmerges)


@pytest.mark.parametrize("arpa,kind", [("words", "char"), ("w400", "char"), ("tokens", "word"),
                                       ("words", "bpe")])
def test_builders_equal_the_jax_builders(arpas, arpa, kind):
    jt, pt = _tokenizers(kind)
    V = jt.vocab_size
    assert pt.vocab_size == V
    jm, pm = jax_lm.ArpaLanguageModel(arpas[arpa]), port_lm.ArpaLanguageModel(arpas[arpa])
    granular = jax_lm.tokenizer_is_word_granular(jt, V)
    assert port_lm.tokenizer_is_word_granular(pt, V) is granular
    assert granular is (kind == "word")
    for name in ("build_arpa_fusion_tables", "build_trie_fusion_tables",
                 "build_hash_fusion_tables"):
        want = getattr(jax_lm, name)(jm, jt, V)
        got = getattr(port_lm, name)(pm, pt, V)
        _same(want, got, name)
    trie = jax_lm.build_trie_fusion_tables(jm, jt, V)
    if trie is not None:
        _same(jax_lm.derive_fused_trie_advance(trie["ptrans"], trie["wid"], trie["tok_kind"]),
              port_lm.derive_fused_trie_advance(trie["ptrans"], trie["wid"], trie["tok_kind"]))
    texts = WORD_TEXTS if kind == "word" else BPE_TEXTS
    _same(jax_lm.token_bigram_matrix(texts, jt, V), port_lm.token_bigram_matrix(texts, pt, V))


def test_size_guards_pick_the_same_form(arpas, monkeypatch):
    """The entry budgets are kept: with them lowered below the 400-word
    tables, both packages refuse the trie and fall to the hash form."""
    jt, pt = _tokenizers("char")
    jm, pm = jax_lm.ArpaLanguageModel(arpas["w400"]), port_lm.ArpaLanguageModel(arpas["w400"])
    for mod, m, t in ((jax_lm, jm, jt), (port_lm, pm, pt)):
        assert mod.build_trie_fusion_tables(m, t, 56, max_entries=1_000_000) is None
        assert mod.build_trie_fusion_tables(m, t, 56, max_entries=1_000_000_000) is not None
        assert mod.build_hash_fusion_tables(m, t, 56, max_entries=100) is None


@pytest.mark.parametrize("n_words,seed,ngram_counts",
                         [(400, 0, None), (30, 3, {2: 40, 3: 25, 4: 10})])
def test_synthetic_arpa_is_benchs(tmp_path, n_words, seed, ngram_counts):
    want, got = tmp_path / "bench.arpa", tmp_path / "port.arpa"
    bench._synthetic_word_arpa(str(want), n_words=n_words, seed=seed, ngram_counts=ngram_counts)
    synthetic_word_arpa(str(got), n_words=n_words, seed=seed, ngram_counts=ngram_counts)
    assert got.read_bytes() == want.read_bytes()


def _logits(seed, B, T, V):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2.0, (B, T, V)).astype(np.float32)
    x[..., 0] -= 1.0
    return x


@pytest.mark.parametrize("lm_kind", ["arpa", "ngram", "none"])
def test_host_beam_gives_the_jax_texts(arpas, lm_kind):
    jt, pt = _tokenizers("char")
    if lm_kind == "arpa":
        jlm, plm = jax_lm.KenLMModel(arpas["words"]), port_lm.KenLMModel(arpas["words"])
    elif lm_kind == "ngram":
        jlm, plm = jax_lm.NGramLanguageModel(), port_lm.NGramLanguageModel()
        jlm.train(BPE_TEXTS, jt)
        plm.train(BPE_TEXTS, pt)
    else:
        jlm = plm = None
    logits = _logits(1, 3, 14, 56)
    lengths = np.array([14, 9, 5], np.int32)
    want = jax_beam.CTCBeamDecoder(jt, beam_width=6, lm=jlm, lm_weight=0.5).decode_batch(
        logits, lengths)
    got = port_beam.CTCBeamDecoder(pt, beam_width=6, lm=plm, lm_weight=0.5).decode_batch(
        logits, lengths)
    assert got == want


@pytest.mark.parametrize("form", ["none", "bias", "tables", "trie", "hash"])
@pytest.mark.parametrize("word_bonus", [0.0, 0.5])
def test_device_beam_decoder_gives_the_jax_texts(arpas, form, word_bonus):
    kind = "word" if form in ("bias", "tables") else "char"
    jt, pt = _tokenizers(kind)
    V = jt.vocab_size
    kw = {}
    if form == "bias":
        kw["lm_bias"] = jax_lm.token_bigram_matrix(WORD_TEXTS, jt, V)
    elif form == "tables":
        kw["lm_tables"] = jax_lm.build_arpa_fusion_tables(
            jax_lm.ArpaLanguageModel(arpas["tokens"]), jt, V)
    elif form in ("trie", "hash"):
        build = getattr(jax_lm, f"build_{form}_fusion_tables")
        kw[f"lm_{form}"] = build(jax_lm.ArpaLanguageModel(arpas["words"]), jt, V)
    logits = _logits(2, 3, 16, V)
    lengths = np.array([16, 11, 6], np.int32)
    want = jax_factory.DeviceBeamDecoder(jt, beam_width=8, lm_weight=0.8,
                                         word_bonus=word_bonus, **kw).decode_batch(logits, lengths)
    port = port_factory.DeviceBeamDecoder(pt, beam_width=8, lm_weight=0.8,
                                          word_bonus=word_bonus, device="cpu", **kw)
    assert port.decode_batch(torch.from_numpy(logits), torch.from_numpy(lengths)) == want
    assert port.decode(logits[1, :11]) == want[1]


def test_flashlight_slot_gives_the_jax_texts(arpas):
    jt, pt = _tokenizers("char")
    logits = _logits(3, 2, 12, 56)
    want = jax_factory.create_decoder(jt, "flashlight", arpas["words"], beam_width=6)
    got = port_factory.create_decoder(pt, "flashlight", arpas["words"], beam_width=6,
                                      device="cpu")
    assert isinstance(got._impl, port_factory.DeviceBeamDecoder)
    assert got.decode_batch(logits) == want.decode_batch(logits)
    host = port_factory.create_decoder(pt, "beam", arpas["words"], beam_width=6)
    assert host.decode_batch(logits) == jax_factory.create_decoder(
        jt, "beam", arpas["words"], beam_width=6).decode_batch(logits)


def test_device_decoder_needs_the_card_it_names():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_factory.DeviceBeamDecoder(PortTok(), beam_width=4)
