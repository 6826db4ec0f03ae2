"""Data augmentation: SpecAugment on the device, and the host-side
SpecAugment, speed perturbation and noise injection.

Counterpart of turkish_asr_tpu/audio/augment.py. ``spec_augment_batch`` is
``spec_augment_batch`` (:53-86): torchaudio-style masks, width =
int(u1 * param) and start = int(u2 * (len - width)), time masks bounded by
each row's valid length (a mask never reaches into padding), fill 0. Its
uniform draws come from an explicit ``torch.Generator`` on the features'
device, so they are not JAX's draws; the tests hold the invariants. The
host classes are copied as numpy.
"""

import glob

import numpy as np
import torch

from turkish_asr_torch.audio.wavio import load_audio, resample


def _mask_axis(x, u, mask_param, axis, axis_len, valid_len=None):
    """One mask per row on ``axis`` (1 = time, 2 = frequency) of (B, T, F)
    from the (B, 2) uniforms ``u``."""
    value = u[:, 0] * mask_param
    if valid_len is not None:
        value = torch.minimum(value, valid_len)
    span = (valid_len if valid_len is not None else float(axis_len)) - value
    start = (u[:, 1] * torch.clamp(span, min=0.0)).to(torch.int32)
    end = start + value.to(torch.int32)
    pos = torch.arange(axis_len, device=x.device)[None, :]
    hit = (pos >= start[:, None]) & (pos < end[:, None])  # (B, axis_len)
    hit = hit[:, :, None] if axis == 1 else hit[:, None, :]
    return torch.where(hit, 0.0, x)


def spec_augment_batch(features, generator, lengths=None, *, freq_mask_param=27,
                       time_mask_param=100, n_freq_masks=2, n_time_masks=2):
    """SpecAugment on a (B, T, F) batch, independent masks per row.

    Args:
        features: (B, T, F) float features.
        generator: a ``torch.Generator`` on the features' device.
        lengths: optional (B,) valid frame counts (bound the time masks).
    """
    B, T, F = features.shape
    u = torch.rand((n_freq_masks + n_time_masks, B, 2), generator=generator,
                   device=features.device)
    valid = (torch.full((B,), float(T), device=features.device) if lengths is None
             else lengths.to(device=features.device, dtype=torch.float32))
    x = features
    for i in range(n_freq_masks):
        x = _mask_axis(x, u[i], freq_mask_param, axis=2, axis_len=F)
    for i in range(n_time_masks):
        x = _mask_axis(x, u[n_freq_masks + i], time_mask_param, axis=1, axis_len=T,
                       valid_len=valid)
    return x


class SpecAugment:
    """Host-side per-utterance SpecAugment on (T, F) numpy features."""

    def __init__(self, freq_mask_param=27, time_mask_param=100,
                 n_freq_masks=2, n_time_masks=2, rng=None):
        self.freq_mask_param = freq_mask_param
        self.time_mask_param = time_mask_param
        self.n_freq_masks = n_freq_masks
        self.n_time_masks = n_time_masks
        self.rng = rng or np.random.default_rng()

    def __call__(self, features):
        x = np.array(features, dtype=np.float32, copy=True)
        T, F = x.shape
        for _ in range(self.n_freq_masks):
            width = int(self.rng.uniform() * self.freq_mask_param)
            start = int(self.rng.uniform() * (F - width))
            x[:, start:start + width] = 0.0
        for _ in range(self.n_time_masks):
            width = int(self.rng.uniform() * self.time_mask_param)
            start = int(self.rng.uniform() * (T - width))
            x[start:start + width, :] = 0.0
        return x


class SpeedPerturbation:
    """Random 3-way speed perturbation via resampling (pitch shifts too)."""

    def __init__(self, speeds=(0.9, 1.0, 1.1), rng=None):
        self.speeds = speeds
        self.rng = rng or np.random.default_rng()

    def __call__(self, waveform, sample_rate):
        speed = self.speeds[int(self.rng.integers(len(self.speeds)))]
        if speed == 1.0:
            return waveform
        # output_len = input_len * new/orig; want input_len/speed => new = orig/speed
        new_freq = int(sample_rate / speed)
        return resample(waveform, sample_rate, new_freq)


class NoisePerturbation:
    """SNR-controlled additive noise from a directory of wav files."""

    def __init__(self, noise_dir=None, snr_range=(5.0, 20.0), rng=None):
        self.noise_dir = noise_dir
        self.snr_range = snr_range
        self.rng = rng or np.random.default_rng()
        self.noise_files = []
        if noise_dir:
            self.noise_files = glob.glob(f"{noise_dir}/**/*.wav", recursive=True)

    def __call__(self, waveform, sample_rate):
        if not self.noise_files:
            return waveform
        x = np.asarray(waveform, dtype=np.float32).reshape(-1)
        idx = int(self.rng.integers(len(self.noise_files)))
        noise, _ = load_audio(self.noise_files[idx], sample_rate)
        if noise.shape[0] < x.shape[0]:
            repeats = x.shape[0] // noise.shape[0] + 1
            noise = np.tile(noise, repeats)
        noise = noise[: x.shape[0]]
        snr = float(self.rng.uniform(*self.snr_range))
        signal_power = np.mean(x ** 2)
        noise_power = np.mean(noise ** 2) + 1e-12
        scale = np.sqrt(signal_power / (noise_power * (10 ** (snr / 10))))
        return x + scale.astype(np.float32) * noise
