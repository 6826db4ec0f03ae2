"""Port's log-mel front-end and AudioPreprocessor against the JAX ones on
the same waveforms and files.

Tolerance 1e-4 absolute on CMVN-normalized features: the bar
tests/test_features.py holds the JAX front-end to against its fp64 oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.audio.features import AudioPreprocessor as JaxAudioPreprocessor
from turkish_asr_tpu.audio.features import log_mel_spectrogram as jax_log_mel
from turkish_asr_torch.audio.features import AudioPreprocessor, log_mel_spectrogram
from turkish_asr_torch.audio.wavio import write_wav

ATOL = 1e-4


def _waves(lengths, S, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), S), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal(n) * 0.1
    return x


@pytest.mark.parametrize("lengths,S", [
    ([16000, 9000, 401, 1], 16000),   # ragged rows, one of one sample
    ([24000, 24000], 24000),          # full rows
])
def test_padded_batch_matches_jax(lengths, S):
    x = _waves(lengths, S, seed=0)
    lens = np.asarray(lengths, np.int32)
    want, want_fl = jax_log_mel(jnp.asarray(x), jnp.asarray(lens))
    got, got_fl = log_mel_spectrogram(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_fl.numpy(), np.asarray(want_fl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_single_utterance_matches_jax():
    x = _waves([12345], 12345, seed=1)[0]
    want = jax_log_mel(jnp.asarray(x))
    got = log_mel_spectrogram(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("S,lengths", [(400, None), (300, [300, 150]), (120, [120, 7])])
def test_short_input_gather_path_matches_jax(S, lengths):
    """Inputs of at most n_fft samples take the gather fallback."""
    B = 1 if lengths is None else len(lengths)
    x = _waves(lengths or [S], S, seed=2)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want, _ = jax_log_mel(jnp.asarray(x), None if lens is None else jnp.asarray(lens))
    got, _ = log_mel_spectrogram(torch.from_numpy(x),
                                 None if lens is None else torch.from_numpy(lens))
    assert got.shape == (B, 1 + S // 160, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_padded_row_equals_unpadded_utterance():
    x = _waves([9000], 9000, seed=3)
    padded = np.zeros((1, 16000), np.float32)
    padded[0, :9000] = x[0]
    alone, _ = log_mel_spectrogram(torch.from_numpy(x), torch.tensor([9000]))
    inpad, fl = log_mel_spectrogram(torch.from_numpy(padded), torch.tensor([9000]))
    n = int(fl[0])
    np.testing.assert_allclose(inpad[0, :n].numpy(), alone[0, :n].numpy(), atol=ATOL)


@pytest.mark.parametrize("n_mels,normalize", [(80, True), (40, False)])
def test_audio_preprocessor_matches_jax(tmp_path, n_mels, normalize):
    """A 22.05 kHz stereo file: decoded, mixed to mono and resampled to the
    same waveform, then featurized on the CPU within 1e-4."""
    path = str(tmp_path / "a.wav")
    x = np.random.default_rng(4).standard_normal((2, 30000)).astype(np.float32) * 0.2
    write_wav(path, x, 22050)
    port = AudioPreprocessor(n_mels=n_mels, normalize=normalize, device="cpu")
    ref = JaxAudioPreprocessor(n_mels=n_mels, normalize=normalize)
    wave, sr = port.load_audio(path)
    want_wave, want_sr = ref.load_audio(path)
    assert sr == want_sr == 16000
    np.testing.assert_array_equal(wave, want_wave)
    got, want = port(path), ref(path)
    assert got.shape == want.shape == (1 + len(wave) // 160, n_mels)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_audio_preprocessor_runs_on_the_card_or_raises(monkeypatch):
    """The default device is the card; without one the constructor raises,
    and the CPU is used only when the caller names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            AudioPreprocessor(**kw)
    assert AudioPreprocessor(device="cpu").device == torch.device("cpu")
