"""Port's log-mel front-end against the JAX one on the same waveforms.

Tolerance 1e-4 absolute on CMVN-normalized features: the bar
tests/test_features.py holds the JAX front-end to against its fp64 oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.audio.features import log_mel_spectrogram as jax_log_mel
from turkish_asr_torch.audio.features import log_mel_spectrogram

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
