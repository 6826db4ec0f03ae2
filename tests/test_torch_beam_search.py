"""The port's batched CTC beam search against the JAX package's.

The same seeded log-probs go through ``turkish_asr_tpu.ops.beam_search.
ctc_beam_search`` (on the CPU) and ``turkish_asr_torch.ops.beam_search.
ctc_beam_search`` in every fusion form: no LM, a token-bigram bias, ARPA
state tables (a word tokenizer of V = 12), and the trie and hash forms
(the char tokenizer, V = 56), the hash form with and without its
probe-dedup. Ids and counts must be identical; scores agree within
rtol 1e-5, atol 1e-4 (both sum the same fp32 terms; logaddexp's last bit
may differ). The log-probs are log_softmax of finite logits: the JAX
search's one-hot lookups turn a -inf log-prob into NaN, a gather does not.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turkish_asr_tpu.data.tokenizer import TurkishTokenizer  # noqa: E402
from turkish_asr_tpu.decode import lm as jax_lm  # noqa: E402
from turkish_asr_tpu.ops.beam_search import ctc_beam_search as jax_search  # noqa: E402
from turkish_asr_torch.ops.beam_search import ctc_beam_search  # noqa: E402
from beam_fixtures import TOKEN_ARPA, WORD_ARPA, WORDS, WordTok  # noqa: E402


def _peaked(rng, B, T, V, targets, peak=4.0):
    """log_softmax of noise with each utterance's target ids spelt on
    every other frame (blank between), so prefixes grow and compete."""
    x = rng.standard_normal((B, T, V)).astype(np.float32)
    for b in range(B):
        seq = targets[b % len(targets)]
        for i, tok in enumerate(seq):
            if 2 * i < T:
                x[b, 2 * i, tok] += peak
        x[b, 1::2, 0] += peak / 2
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))


def _compare(lp, lengths, W, all_beams, max_prefix_len=None, jax_kw=None, port_kw=None):
    want = jax_search(jnp.asarray(lp), None if lengths is None else jnp.asarray(lengths),
                      beam_width=W, blank_id=0, max_prefix_len=max_prefix_len,
                      return_all_beams=all_beams, **(jax_kw or {}))
    got = ctc_beam_search(torch.from_numpy(lp.copy()),
                          None if lengths is None else torch.from_numpy(lengths),
                          beam_width=W, blank_id=0, max_prefix_len=max_prefix_len,
                          return_all_beams=all_beams, **(port_kw or jax_kw or {}))
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    if all_beams:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-4)
    return got


@pytest.fixture(scope="module")
def word_arpa(tmp_path_factory):
    p = tmp_path_factory.mktemp("lm") / "words.arpa"
    p.write_text(WORD_ARPA)
    return str(p)


@pytest.fixture(scope="module")
def char_tok():
    return TurkishTokenizer()


@pytest.fixture(scope="module")
def char_targets(char_tok):
    return [char_tok.encode(s) for s in ("bir iki bin o", "iki o ev bir", "ev bir iki")]


@pytest.fixture(scope="module")
def fusion(word_arpa, char_tok, tmp_path_factory):
    model = jax_lm.ArpaLanguageModel(word_arpa)
    p = tmp_path_factory.mktemp("lm") / "tokens.arpa"
    p.write_text(TOKEN_ARPA)
    tables = jax_lm.build_arpa_fusion_tables(jax_lm.ArpaLanguageModel(str(p)), WordTok(),
                                             len(WORDS))
    trie = jax_lm.build_trie_fusion_tables(model, char_tok, char_tok.vocab_size)
    hashed = jax_lm.build_hash_fusion_tables(model, char_tok, char_tok.vocab_size)
    assert tables is not None and trie is not None and hashed is not None
    assert len(hashed["uniq_q"]) == 2
    return {"tables": tables, "trie": trie, "hash": hashed}


CASES = [(4, False), (8, True)]


@pytest.mark.parametrize("W,all_beams", [(4, False), (4, True), (8, False), (8, True)])
def test_no_lm(W, all_beams):
    rng = np.random.default_rng(W)
    lp = _peaked(rng, 3, 50, 12, [[3, 5, 5, 2, 9], [1, 1, 7, 4], [11, 2, 6, 6, 8, 1]])
    _compare(lp, np.array([50, 31, 9]), W, all_beams)


@pytest.mark.parametrize("W,all_beams", CASES)
def test_bias(W, all_beams):
    rng = np.random.default_rng(10 + W)
    lp = _peaked(rng, 3, 40, 12, [[3, 5, 2, 9], [1, 7, 4]])
    bias = (-3.0 * rng.random((13, 12))).astype(np.float32)
    _compare(lp, np.array([40, 40, 17]), W, all_beams,
             jax_kw={"lm_bias": jnp.asarray(bias), "lm_weight": 0.5},
             port_kw={"lm_bias": bias, "lm_weight": 0.5})


@pytest.mark.parametrize("W,all_beams", CASES)
def test_arpa_tables(W, all_beams, fusion):
    score, nxt, start = fusion["tables"]
    rng = np.random.default_rng(20 + W)
    lp = _peaked(rng, 3, 40, 12, [[1, 2, 3, 1], [2, 3, 5, 4, 1], [6, 1, 2]])
    _compare(lp, np.array([40, 22, 40]), W, all_beams,
             jax_kw={"lm_tables": (jnp.asarray(score), jnp.asarray(nxt)),
                     "lm_start_state": int(start), "lm_weight": 0.8},
             port_kw={"lm_tables": (score, nxt), "lm_start_state": int(start),
                      "lm_weight": 0.8})


@pytest.mark.parametrize("W,all_beams", CASES)
def test_trie(W, all_beams, fusion, char_targets):
    trie = fusion["trie"]
    rng = np.random.default_rng(30 + W)
    lp = _peaked(rng, 3, 50, 56, char_targets, peak=3.0)
    _compare(lp, np.array([50, 50, 21]), W, all_beams,
             jax_kw={"lm_trie": trie, "lm_start_state": int(trie["start_h"]),
                     "lm_weight": 1.0})


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("W,all_beams", CASES)
def test_hash(W, all_beams, dedup, fusion, char_targets):
    """With uniq_q (K2 = 2 < K) each step probes the two distinct word ids
    and picks columns; without it, every candidate's word is probed."""
    hashed = dict(fusion["hash"])
    if not dedup:
        del hashed["uniq_q"], hashed["qcol"]
    rng = np.random.default_rng(40 + W)
    lp = _peaked(rng, 3, 50, 56, char_targets, peak=3.0)
    _compare(lp, np.array([37, 50, 50]), W, all_beams,
             jax_kw={"lm_hash": hashed, "lm_weight": 1.0})


@pytest.fixture(scope="module")
def bpe_fusion(word_arpa):
    """A BPE tokenizer whose pieces carry word markers: its tokens take
    the trie's kinds 0-3, kind 3 (" frag") among them."""
    from turkish_asr_tpu.data.bpe import BPETokenizer, train_bpe
    vocab, merges = train_bpe(["bir iki bin ev o bir iki", "iki bin o ev bir bin iki"],
                              vocab_size=48)
    bpe = BPETokenizer(vocab, merges)
    model = jax_lm.ArpaLanguageModel(word_arpa)
    trie = jax_lm.build_trie_fusion_tables(model, bpe, bpe.vocab_size)
    hashed = jax_lm.build_hash_fusion_tables(model, bpe, bpe.vocab_size)
    assert 3 in set(trie["tok_kind"].tolist())
    targets = [bpe.encode(s) for s in ("bir iki bin o", "iki o ev bir", "ev bir iki")]
    return bpe.vocab_size, targets, {"lm_trie": trie, "lm_start_state": int(trie["start_h"]),
                                     "lm_weight": 1.0}, {"lm_hash": hashed, "lm_weight": 1.0}


@pytest.mark.parametrize("form", ["trie", "hash"])
def test_bpe_word_markers(form, bpe_fusion):
    V, targets, trie_kw, hash_kw = bpe_fusion
    rng = np.random.default_rng(60)
    lp = _peaked(rng, 3, 30, V, targets, peak=3.0)
    _compare(lp, np.array([30, 30, 19]), 4, True,
             jax_kw=trie_kw if form == "trie" else hash_kw)


def test_hash_order4(tmp_path, char_tok):
    """An order-4 ARPA (bench's generator, small): three context lengths
    probed together."""
    import bench
    path = str(tmp_path / "order4.arpa")
    bench._synthetic_word_arpa(path, n_words=30, seed=3, ngram_counts={2: 60, 3: 60, 4: 60})
    model = jax_lm.ArpaLanguageModel(path)
    hashed = jax_lm.build_hash_fusion_tables(model, char_tok, char_tok.vocab_size)
    assert hashed["ctx_len"] == 3
    # Spell the ARPA's own 3-grams and a word: the next word's first
    # characters are scored in a 3-word context that has a backoff.
    grams = sorted(g for g in model.logprob if len(g) == 3)
    rng = np.random.default_rng(70)
    targets = [char_tok.encode(" ".join(grams[i] + grams[i][:1])) for i in
               rng.choice(len(grams), 3)]
    lp = _peaked(rng, 3, 60, 56, targets, peak=6.0)
    _compare(lp, np.array([60, 52, 60]), 4, True, jax_kw={"lm_hash": hashed, "lm_weight": 1.0})


def test_hash_matches_trie(fusion, char_targets):
    """The hash and trie forms score the same ARPA: the same beams."""
    rng = np.random.default_rng(5)
    lp = torch.from_numpy(_peaked(rng, 3, 50, 56, char_targets, peak=3.0).copy())
    trie = fusion["trie"]
    a = ctc_beam_search(lp, beam_width=8, lm_trie=trie, lm_start_state=int(trie["start_h"]),
                        return_all_beams=True)
    b = ctc_beam_search(lp, beam_width=8, lm_hash=fusion["hash"], return_all_beams=True)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("L", [1, 5])
def test_max_prefix_len_truncates(L):
    rng = np.random.default_rng(50 + L)
    lp = _peaked(rng, 2, 30, 12, [[3, 5, 2, 9, 4, 7, 1, 8, 6], [1, 7, 4, 2, 3]], peak=6.0)
    for all_beams in (False, True):
        ids, counts = _compare(lp, np.array([30, 30]), 4, all_beams, max_prefix_len=L)[:2]
        assert ids.shape[-1] == L and int(counts.max()) <= L


@pytest.mark.parametrize("W", [4, 8])
def test_uniform_frames_pin_tie_order(W):
    """Every token equally likely: extends tie exactly, and the survivors
    are the lower candidate indices, as jax.lax.top_k keeps them."""
    lp = np.full((2, 6, 12), -np.log(12.0), dtype=np.float32)
    ids, counts, scores = _compare(lp, np.array([6, 4]), W, True)
    assert len(set(scores[0].tolist())) < W  # the tie is real


def test_beam_wider_than_finite_candidates():
    """tests/test_decode.py:114: W = 16 over V = 11 and two frames; the
    dead rows' negative hash seeds keep them from merging with a prefix."""
    V, T, W = 11, 2, 16
    logits = np.full((1, T, V), -8.0, dtype=np.float32)
    logits[0, 0, 2] = 6.0
    logits[0, 1, 10] = 6.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    for all_beams in (False, True):
        got = _compare(lp, None, W, all_beams)
    ids, counts = ctc_beam_search(torch.from_numpy(lp.copy()), beam_width=W)
    assert ids[0, :int(counts[0])].tolist() == [2, 10]


def test_more_than_one_lm_is_refused(fusion):
    with pytest.raises(ValueError, match="at most one"):
        ctc_beam_search(torch.zeros(1, 2, 56), lm_trie=fusion["trie"], lm_hash=fusion["hash"])


def test_tables_for_another_vocab_are_refused(fusion):
    with pytest.raises(ValueError, match="vocab_size=56"):
        ctc_beam_search(torch.zeros(1, 2, 12), lm_hash=fusion["hash"])
