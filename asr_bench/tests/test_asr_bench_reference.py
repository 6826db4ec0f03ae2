"""The plain reference against the port at a tiny size on the CPU, and the
comparisons that decide ``correct``. This test imports both; the harness's
reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from asr_bench import common, traffic
from asr_bench.reference import conformer_ctc as ref
from asr_bench.reference import judge
from asr_bench.reference.bpe import Vocabulary
from asr_bench.weights import make_state_dict, param_count

TINY = dict(common.load_json("configs", "flagship"), d_model=32, n_heads=2, n_blocks=2)


def port_model(cfg, sd):
    from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig
    model = ConformerCTC(ModelConfig(n_mels=cfg["n_mels"], d_model=cfg["d_model"],
                                     n_heads=cfg["n_heads"], n_blocks=cfg["n_blocks"],
                                     n_classes=cfg["n_classes"], dropout=cfg["dropout"]))
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("name", ["flagship"])
def test_weights_load_into_the_port(name):
    cfg = common.load_json("configs", name)
    assert param_count(cfg) == cfg["params"]
    small = dict(cfg, n_blocks=1)
    sd = make_state_dict(small, 3, "cpu", served=True)
    port_model(small, sd)
    assert torch.equal(sd["fc.weight"], make_state_dict(small, 3, "cpu", served=True)["fc.weight"])
    assert not torch.equal(sd["fc.weight"], make_state_dict(small, 4, "cpu")["fc.weight"])


def test_features_match_the_port():
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    rng = traffic.rng_of(1, 1)
    waves = [traffic.samples(n, rng).astype(np.float32) / 32768.0 for n in (17000, 30000)]
    S = 32000
    mine, lengths = ref.features(waves, S)
    padded = np.zeros((2, S), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    port, port_len = log_mel_spectrogram(torch.from_numpy(padded),
                                         torch.tensor([len(w) for w in waves]))
    assert torch.equal(lengths, port_len.long())
    assert torch.allclose(mine.float(), port, atol=2e-4)


def test_logits_match_the_port_in_fp32():
    sd = make_state_dict(TINY, 5, "cpu", served=True)
    rng = traffic.rng_of(2, 1)
    waves = [traffic.samples(n, rng).astype(np.float32) / 32768.0 for n in (20000, 26000)]
    S = ref.bucket(26000)
    mine = ref.logits_of(sd, TINY, waves, "fp32")
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    padded = np.zeros((2, S), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    lens = torch.tensor([len(w) for w in waves])
    feats, frames = log_mel_spectrogram(torch.from_numpy(padded), lens)
    with torch.no_grad():
        port = port_model(TINY, sd).eval()(feats, frames, torch.float32)
    for i in range(2):
        n = int(frames[i]) // 4
        assert torch.allclose(mine[i], port[i, :n], atol=2e-3), (mine[i] - port[i, :n]).abs().max()


def test_text_gap():
    """Every spelling of the text counts: "ab" as "a", "b" or as "ab", a
    leading word mark or none, the word mark alone at either end."""
    vocab = Vocabulary(["<blank>", "<unk>", "a", "b", "▁", "▁a", "ab", "▁ab"],
                       [["▁", "a"], ["a", "b"], ["▁a", "b"]])
    a, b, sp, sp_a, ab = 2, 3, 4, 5, 6
    path = [0, sp_a, sp_a, 0, b, sp, 1, ab, 0]          # "▁a", "b", "▁", <unk>, "ab"
    logits = np.full((len(path), len(vocab)), -1.0)
    logits[np.arange(len(path)), path] = 1.0
    assert vocab.greedy_text(logits) == "ab ab"
    assert judge.text_gap(logits, "ab ab", vocab) == 0.0
    assert judge.text_gap(logits, "abab", vocab) == 2.0      # the word mark's frame 2 below
    assert judge.text_gap(logits, "ab a", vocab) == 2.0
    assert judge.text_gap(logits, "ab abc", vocab) == float("inf")   # not in the vocabulary
    assert judge.text_gap(logits[:1], "ab ab", vocab) == float("inf")    # too few frames
    near = logits.copy()
    near[7, a] = 0.99                          # a near tie the text did not take
    near[8, b] = 0.99
    assert judge.text_gap(near, "ab ab", vocab) == 0.0
    assert abs(judge.text_gap(near, "ab aab", vocab) - 2.0) < 1e-9
    assert abs(judge.text_gap(near[:8], "ab a", vocab) - 0.01) < 1e-9


def test_vocabulary_matches_the_port():
    """The reference's encoder and decoder of the configuration's file
    against the port's BPE tokenizer, which loads the same file."""
    from turkish_asr_torch.data.tokenizer import load_tokenizer
    cfg = common.load_json("configs", "flagship")
    vocab = Vocabulary.of(cfg)
    port = load_tokenizer(str(common.ROOT / cfg["vocabulary"]))
    assert len(vocab) == port.vocab_size == cfg["n_classes"]
    rng = traffic.rng_of(6, 4)
    for n in (16000, 80000, 160000):
        text = traffic.transcript(n, 12, rng)
        ids = vocab.encode(text)
        assert ids == port.encode(text) and 1 not in ids
        assert vocab.decode(ids) == port.decode(ids) == text
    ids = rng.integers(0, len(vocab), 300).tolist()
    assert vocab.decode(ids) == port.decode(ids)
