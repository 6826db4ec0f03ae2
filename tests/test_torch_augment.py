"""The port's augmentation (audio/augment.py) and resampler.

``spec_augment_batch`` draws from a torch.Generator, not from jax.random,
so it is held to the invariants tests/test_augment.py holds the JAX
version to: time masks stay inside each row's valid frames (padding gets
only the frequency stripes, which span all frames as in JAX), frequency
masks are whole stripes, and every mask is one contiguous run no wider
than its parameter. The host classes are copies and
are held against the JAX package's on the same numpy generator state. The
resampler is held against the JAX package's at ratios whose polyphase bank
is small, within 1e-5: where both packages load their native library the
bits are equal (tests/test_torch_native.py), and without it the JAX
package's numpy fallback sums float32 products in another order (5e-7
measured).
"""

import numpy as np
import pytest
import torch

from turkish_asr_tpu.audio import augment as jax_augment
from turkish_asr_tpu.audio.wavio import resample as jax_resample
from turkish_asr_torch.audio.augment import (
    NoisePerturbation, SpecAugment, SpeedPerturbation, spec_augment_batch)
from turkish_asr_torch.audio.wavio import resample, write_wav


def _runs(zero_positions):
    """Number of contiguous runs in a sorted index list."""
    if len(zero_positions) == 0:
        return 0
    return 1 + int(np.sum(np.diff(zero_positions) > 1))


def test_masks_zero_something_and_are_reproducible():
    x = torch.ones(2, 120, 80)
    a = spec_augment_batch(x, torch.Generator().manual_seed(0))
    b = spec_augment_batch(x, torch.Generator().manual_seed(0))
    assert a.shape == x.shape and torch.equal(a, b)
    assert (a == 0).sum() > 0 and (a == 1).sum() > 0


def test_time_masks_stay_inside_valid_frames():
    B, T, F = 4, 200, 8
    valid = torch.tensor([5, 9, 3, 7])
    x = torch.ones(B, T, F)
    for seed in range(40):
        out = spec_augment_batch(x, torch.Generator().manual_seed(seed), valid,
                                 freq_mask_param=0, time_mask_param=100)
        for b in range(B):
            assert (out[b, valid[b]:] == 1).all(), f"seed {seed} row {b}: mask in padding"


@pytest.mark.parametrize("seed", range(5))
def test_masks_are_stripes_no_wider_than_their_parameter(seed):
    """The frequency masks (time_mask_param 0) zero whole columns across
    all frames; the time masks (freq_mask_param 0) zero whole rows inside
    the valid frames; each is at most two runs of at most param each."""
    B, T, F, fp, tp = 3, 150, 80, 27, 100
    lengths = torch.tensor([150, 90, 40])
    freq = spec_augment_batch(torch.ones(B, T, F), torch.Generator().manual_seed(seed), lengths,
                              freq_mask_param=fp, time_mask_param=0).numpy()
    time = spec_augment_batch(torch.ones(B, T, F), torch.Generator().manual_seed(seed), lengths,
                              freq_mask_param=0, time_mask_param=tp).numpy()
    for b in range(B):
        cols = (freq[b] == 0).all(axis=0)
        assert ((freq[b] == 1) | cols[None]).all()
        assert _runs(np.where(cols)[0]) <= 2 and cols.sum() <= 2 * fp
        rows = (time[b] == 0).all(axis=1)
        assert ((time[b] == 1) | rows[:, None]).all()
        assert _runs(np.where(rows)[0]) <= 2 and rows.sum() <= 2 * tp
        assert not rows[lengths[b]:].any()


def test_host_classes_match_the_jax_package():
    x = np.random.default_rng(0).standard_normal((130, 80)).astype(np.float32)
    got = SpecAugment(rng=np.random.default_rng(1))(x)
    want = jax_augment.SpecAugment(rng=np.random.default_rng(1))(x)
    np.testing.assert_array_equal(got, want)
    w = np.random.default_rng(2).standard_normal(4000).astype(np.float32)
    for seed in range(4):
        got = SpeedPerturbation(speeds=(1.1, 1.0), rng=np.random.default_rng(seed))(w, 16000)
        want = jax_augment.SpeedPerturbation(speeds=(1.1, 1.0),
                                             rng=np.random.default_rng(seed))(w, 16000)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert NoisePerturbation(noise_dir=None)(w, 16000) is w


def test_noise_perturbation_mixes_at_the_drawn_snr(tmp_path):
    write_wav(str(tmp_path / "n.wav"), np.random.default_rng(3).uniform(-0.5, 0.5, 1000)
              .astype(np.float32), 16000)
    w = np.random.default_rng(4).standard_normal(3000).astype(np.float32) * 0.1
    got = NoisePerturbation(str(tmp_path), rng=np.random.default_rng(5))(w, 16000)
    want = jax_augment.NoisePerturbation(str(tmp_path), rng=np.random.default_rng(5))(w, 16000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("orig,new,length", [(44100, 16000, 44100), (16000, 8000, 5000),
                                             (8000, 16000, 3000), (16000, 14545, 8000)])
def test_resample_matches_the_jax_package(orig, new, length):
    x = np.random.default_rng(orig + new).standard_normal(length).astype(np.float32)
    got = resample(x, orig, new)
    want = jax_resample(x, orig, new)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert resample(np.stack([x, -x]), orig, new).shape == (2,) + want.shape
