"""The port's data pipeline (turkish_asr_torch/data/dataset.py) against the
JAX package's (turkish_asr_tpu/data/dataset.py) on the CPU, on one seeded
corpus: discovery, the split, the sampler, collation, the waveforms with
and without augmentation, the feature items and the prefetching loader,
and the loader's failure modes (the counterparts of
tests/test_prefetch_errors.py).

Everything the two packages compute on the host is held bit for bit. The
feature items are held to 1e-4, the bar of tests/test_torch_features.py
(the port's log-mel in PyTorch against the JAX one).
"""

import threading

import numpy as np
import pytest

from turkish_asr_tpu.data import dataset as jax_ds
from turkish_asr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from turkish_asr_torch.audio.wavio import write_wav
from turkish_asr_torch.data import dataset as ds
from turkish_asr_torch.data.tokenizer import CharTokenizer

SR = 16000
ATOL = 1e-4
WORDS = ("merhaba", "evet", "hayır", "bir", "iki", "üç", "güneş", "deniz")
# The draws of this seed give speeds 1.1, 1.0, 1.0, 1.1, 1.0, 0.9, 1.1, 1.1
# to the corpus's eight files in order: every speed, and 0.9 once, since
# the JAX package's native resampler takes seconds a call at 16000 -> 17777.
AUGMENT_SEED = 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight WAVs of 0.3-2 s with transcripts (two in a subdirectory), a
    WAV without a transcript, and a directory of two noise files."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "sub").mkdir()
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((0.3, 1.2, 0.7, 2.0, 0.5, 1.6, 0.9, 1.4)):
        where = root / "sub" if i % 3 == 2 else root
        x = (0.2 * rng.standard_normal(int(SR * seconds))).astype(np.float32)
        write_wav(str(where / f"u{i}.wav"), x, SR)
        words = " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 1 + i % 3))
        (where / f"u{i}.txt").write_text(words, encoding="utf-8")
    write_wav(str(root / "orphan.wav"), np.zeros(1000, np.float32), SR)
    noise = tmp_path_factory.mktemp("noise")
    for i in range(2):
        write_wav(str(noise / f"n{i}.wav"),
                  (0.1 * rng.standard_normal(SR // 2)).astype(np.float32), SR)
    return str(root), str(noise)


def _datasets(pairs, **kw):
    return (ds.ASRDataset(pairs, CharTokenizer(), **kw),
            jax_ds.ASRDataset(pairs, JaxTokenizer(), **kw))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_find_files_matches_the_jax_package(corpus):
    root, _ = corpus
    pairs = ds.find_files(root)
    assert pairs == jax_ds.find_files(root)
    assert len(pairs) == 8 and sum("/sub/" in w for w, _ in pairs) == 2


class _Config:
    n_mel_channels = 80
    noise_dir = None
    seed = 7
    train_path = valid_path = test_path = data_path = None
    val_split = test_split = 0.0


@pytest.mark.parametrize("layout", ["dirs", "split"])
def test_create_datasets_matches_the_jax_package(corpus, layout):
    root, _ = corpus
    cfg = _Config()
    if layout == "dirs":
        cfg.train_path, cfg.valid_path, cfg.test_path = root, root + "/sub", root + "/sub"
    else:
        cfg.data_path, cfg.val_split, cfg.test_split = root, 0.25, 0.25
    got = ds.create_datasets(cfg, CharTokenizer(), augment_train=False)
    want = jax_ds.create_datasets(cfg, JaxTokenizer(), augment_train=False)
    assert [d.file_pairs for d in got] == [d.file_pairs for d in want]
    assert [len(d) for d in got] == ([8, 2, 2] if layout == "dirs" else [4, 2, 2])


def test_bucketing_sampler_matches_the_jax_package(corpus):
    port, jax = _datasets(ds.find_files(corpus[0]))
    got = ds.BucketingSampler(port, batch_size=3, shuffle=True, seed=5)
    want = jax_ds.BucketingSampler(jax, batch_size=3, shuffle=True, seed=5)
    assert got.lengths == want.lengths
    for _ in range(2):  # the second epoch's shuffle too
        assert list(got) == list(want)


@pytest.mark.parametrize("buckets", [(ds.DEFAULT_WAVEFORM_BUCKETS, ds.DEFAULT_TARGET_BUCKETS),
                                     ((4000, 8000), (2, 4, 8))], ids=["default", "truncating"])
def test_collate_batch_matches_the_jax_package(corpus, buckets):
    """A ragged batch of five in eight rows: three dummy rows; with the
    small buckets the longest waveforms and targets are cut."""
    port, _ = _datasets(ds.find_files(corpus[0]))
    items = [port.get_waveform(i) for i in range(5)]
    got = ds.collate_batch(items, 8, *buckets)
    want = jax_ds.collate_batch(items, 8, *buckets)
    _assert_batches_equal(got, want)
    np.testing.assert_array_equal(got["sample_mask"], [1] * 5 + [0] * 3)


def test_get_waveform_matches_the_jax_package(corpus):
    port, jax = _datasets(ds.find_files(corpus[0]))
    for i in range(len(port)):
        (w, t), (jw, jt) = port.get_waveform(i), jax.get_waveform(i)
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(t, jt)


def test_augmented_get_waveform_matches_the_jax_package(corpus):
    """Speed and noise perturbation from one seed, called in one thread in
    the same order: the same waveforms bit for bit. The speed perturbation
    resamples at 16000 -> 17777 and 14545, where the JAX package takes its
    native resampler; the port's ``resample`` gives its bits (before the
    port had the native route, its sums ran in another order, 5e-7 apart)."""
    root, noise = corpus
    pairs = ds.find_files(root)
    port, jax = _datasets(pairs, augment=True, speed_perturb=True, noise_dir=noise,
                          seed=AUGMENT_SEED)
    plain, _ = _datasets(pairs)
    speeds = set()
    for i in range(len(port)):
        w, jw = port.get_waveform(i)[0], jax.get_waveform(i)[0]
        np.testing.assert_array_equal(w, jw)
        speeds.add(round(len(plain.get_waveform(i)[0]) / len(w), 1))
    assert speeds == {0.9, 1.0, 1.1}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "spec_augment"])
def test_getitem_features_match_the_jax_package(corpus, augment):
    """The reference's feature item: the port's AudioPreprocessor on the CPU
    against the JAX one, and with ``augment`` the host SpecAugment's masks
    from the same generator."""
    port, jax = _datasets(ds.find_files(corpus[0]), augment=augment, seed=3)
    assert port.preprocessor.device.type == "cpu"
    for i in range(3):
        (f, t), (jf, jt) = port[i], jax[i]
        assert f.shape == jf.shape and f.shape[1] == 80 and f.dtype == np.float32
        np.testing.assert_allclose(f, jf, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(f == 0, jf == 0)
        np.testing.assert_array_equal(t, jt)


def test_prefetch_loader_matches_the_jax_package(corpus):
    port, jax = _datasets(ds.find_files(corpus[0]))
    loaders = [mod.PrefetchLoader(d, mod.BucketingSampler(d, 3, shuffle=True, seed=1), 3,
                                  num_workers=1)
               for mod, d in ((ds, port), (jax_ds, jax))]
    got, want = list(loaders[0]), list(loaders[1])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


class _AllCorrupt:
    """Every sample raises as ``get_waveform`` does when nothing decodes."""

    def __init__(self, n=6):
        self.file_pairs = [(f"/nonexistent/{i}.wav", f"/nonexistent/{i}.txt") for i in range(n)]

    def __len__(self):
        return len(self.file_pairs)

    def get_waveform(self, idx):
        raise RuntimeError("No decodable samples in dataset")


def test_producer_error_reaches_the_consumer_without_a_hang():
    data = _AllCorrupt()
    loader = ds.PrefetchLoader(data, ds.BucketingSampler(data, 2, shuffle=False), 2,
                               num_workers=2)
    raised = []

    def consume():
        try:
            for _ in loader:
                pass
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the consumer still waits 30 s after the producer failed"
    assert len(raised) == 1 and "No decodable samples" in str(raised[0])


@pytest.mark.parametrize("good", [True, False], ids=["then_one_good", "none_decodable"])
def test_corrupt_files_are_skipped_iteratively(tmp_path, good):
    """1500 corrupt files in a row (past Python's recursion limit) are
    skipped to the good one after them; with none decodable, RuntimeError."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    (tmp_path / "bad.txt").write_text("x")
    pairs = [(str(bad), str(tmp_path / "bad.txt"))] * 1500
    if good:
        write_wav(str(tmp_path / "good.wav"), np.zeros(4000, np.float32), SR)
        (tmp_path / "good.txt").write_text("iyi")
        pairs.append((str(tmp_path / "good.wav"), str(tmp_path / "good.txt")))
    data = ds.ASRDataset(pairs, CharTokenizer())
    if good:
        w, t = data.get_waveform(0)
        assert w.shape == (4000,) and len(t) == 3
    else:
        with pytest.raises(RuntimeError, match="No decodable samples"):
            data.get_waveform(0)
