"""``ASRInference.transcribe_files``'s batch staging, on the CPU.

Files load in order; a bucket's batch is dispatched once it holds ``batch_size`` files, and the
partial ones after the last file in ascending length; each is padded into one of a ring of two
reused arenas. ``parent_rule`` is the order this replaces: every file loaded first, then each
bucket's files in index order cut into chunks of ``batch_size`` rows, each padded into a fresh
``np.zeros`` batch. The two must give the same texts and errors, the same batches with logits bit
for bit, and the same counted samples. ``load_behind_forward`` counts the files loaded while a
batch of the call is on the device and not yet decoded; ``staged_pinned`` reads 0 here.

A model of the port's own (d_model 32, 2 blocks) over the character tokenizer; no JAX.
"""

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch

from turkish_asr_torch.audio.wavio import load_audio, write_wav
from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS, bucket_table
from turkish_asr_torch.inference import ASRInference
from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.utils import tracing

SR = 16000
# Seconds of each file, in call order: buckets of 1, 2 and 4 s, a file that fails to load
# ("bad") and one longer than the largest bucket (32 s), transcribed chunked.
SECONDS = [0.6, 1.7, "bad", 3.0, 0.9, 33.0, 1.2, 0.7, 2.6, 1.9, 0.8]
COUNTED = ("forward_samples_valid", "forward_samples_padded", "load_behind_forward",
           "staged_pinned")


@pytest.fixture(scope="module")
def model_pt(tmp_path_factory):
    cfg = ModelConfig(n_mels=80, d_model=32, n_heads=2, n_blocks=2, n_classes=56, dropout=0.0)
    path = tmp_path_factory.mktemp("model") / "model.pt"
    torch.save({"model_state_dict": init_model(cfg, torch.Generator().manual_seed(3)).state_dict(),
                "config": {"n_heads": 2, "n_mel_channels": 80}}, path)
    return str(path)


@pytest.fixture(scope="module")
def asr(model_pt):
    return ASRInference(model_pt, device="cpu", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("staging_wavs")
    rng = np.random.default_rng(20)
    paths = []
    for i, seconds in enumerate(SECONDS):
        path = str(d / f"f{i:02d}.wav")
        if seconds == "bad":
            with open(path, "wb") as f:
                f.write(b"not a wav file")
        else:
            t = np.arange(int(seconds * SR)) / SR
            x = 0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) + 0.05 * rng.standard_normal(t.shape)
            write_wav(path, x.astype(np.float32), SR)
        paths.append(path)
    return paths


def parent_rule(asr, paths, batch_size):
    """(texts, errors) of every file loaded first, then each bucket's files in index order in
    chunks of ``batch_size`` rows, a fresh ``np.zeros`` batch each; the longer files through
    ``transcribe`` after the batches."""
    waves, errors = {}, [None] * len(paths)
    for i, p in enumerate(paths):
        try:
            waves[i] = load_audio(p)[0]
        except Exception as e:  # noqa: BLE001 — the file's error, as the program keeps it
            errors[i] = str(e)
    texts = [""] * len(paths)
    by_bucket = {}
    for i, w in waves.items():
        if w.shape[0] <= DEFAULT_WAVEFORM_BUCKETS[-1]:
            by_bucket.setdefault(bucket_table(w.shape[0], DEFAULT_WAVEFORM_BUCKETS), []).append(i)
    for S, idx in sorted(by_bucket.items()):
        for k in range(0, len(idx), batch_size):
            group = idx[k:k + batch_size]
            wav = np.zeros((batch_size, S), np.float32)
            lens = np.ones((batch_size,), np.int32)
            for j, i in enumerate(group):
                wav[j, :waves[i].shape[0]] = waves[i]
                lens[j] = waves[i].shape[0]
            logits, out_lens = asr._forward_batch(wav, lens)
            for i, text in zip(group, asr.greedy.decode_batch(logits, out_lens)):
                texts[i] = text
    for i, w in waves.items():
        if w.shape[0] > DEFAULT_WAVEFORM_BUCKETS[-1]:
            texts[i] = asr.transcribe(paths[i])
    return texts, errors


def loads_behind_a_forward(batch_size):
    """Files loaded after the call's first batch was dispatched: the first bucket to fill."""
    held, behind, dispatched = collections.Counter(), 0, False
    for seconds in SECONDS:
        if seconds == "bad":
            continue
        behind += dispatched
        if seconds * SR <= DEFAULT_WAVEFORM_BUCKETS[-1]:
            S = bucket_table(int(seconds * SR), DEFAULT_WAVEFORM_BUCKETS)
            held[S] += 1
            dispatched |= held[S] == batch_size
    return behind


def _recorded(asr, fn):
    """(fn's result, [((S, lengths), (waveforms, logits))] of each forward, counters' deltas)."""
    forwards = []
    real = asr._forward_batch

    def forward(wav, lens):
        key = (wav.shape[1], tuple(int(n) for n in lens))
        waveforms = np.array(wav)  # a copy: the staging arena is refilled
        logits, out_lens = real(wav, lens)
        forwards.append((key, (waveforms, logits)))
        return logits, out_lens

    before = tracing.counters()
    asr._forward_batch = forward
    try:
        got = fn()
    finally:
        del asr._forward_batch
    after = tracing.counters()
    return got, forwards, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTED}


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_batches_are_the_parent_rules_in_another_order(asr, files, batch_size):
    (texts, errors), forwards, counted = _recorded(
        asr, lambda: asr.transcribe_files(files, batch_size=batch_size, return_errors=True))
    (want_texts, want_errors), want_forwards, want_counted = _recorded(
        asr, lambda: parent_rule(asr, files, batch_size))
    assert texts == want_texts
    assert errors == want_errors and errors[2] is not None and errors.count(None) == 10
    # the same (S, lengths) batches, the longer file's chunks among them, padded alike (rows'
    # tails and padding rows zero), with equal logits
    assert sorted(k for k, _ in forwards) == sorted(k for k, _ in want_forwards)
    got, want = dict(forwards), dict(want_forwards)
    assert len(got) == len(forwards)  # no two batches alike, so each is matched once
    for key, (waveforms, logits) in got.items():
        assert np.array_equal(waveforms, want[key][0]), key
        assert torch.equal(logits, want[key][1]), key
    for name in ("forward_samples_valid", "forward_samples_padded"):
        assert counted[name] == want_counted[name], name
    assert counted["load_behind_forward"] == loads_behind_a_forward(batch_size)
    assert want_counted["load_behind_forward"] == 0
    assert counted["staged_pinned"] == 0
    # calls one after another reuse one ring of two arenas, which on the CPU holds no events
    assert len(asr._rings) == 1 and len(asr._rings[0].arenas) == 2
    assert asr._rings[0].events == [None, None]


def test_concurrent_calls_never_share_an_arena(asr, files):
    """More threads than cores call ``transcribe_files`` on one ``ASRInference`` at once (the
    server's threads do), each on the files in another order, so its batches differ from its
    neighbours'; each gets the texts of its call made alone."""
    paths = [p for p, s in zip(files, SECONDS) if s != "bad" and s < 32]
    orders = [paths[k % len(paths):] + paths[:k % len(paths)]
              for k in range((os.cpu_count() or 1) + 1)]
    want = [asr.transcribe_files(order, batch_size=2) for order in orders]
    assert any(any(texts) for texts in want)
    got, threads = {}, []

    def call(k):
        got[k] = asr.transcribe_files(orders[k], batch_size=2)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(len(orders)):
            threads.append(threading.Thread(target=call, args=(k,)))
            threads[-1].start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert [got.get(k) for k in range(len(orders))] == want
    assert len(asr._rings) >= 1 and all(len(r.arenas) == 2 for r in asr._rings)
