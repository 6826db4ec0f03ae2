"""Log-mel front-end in PyTorch.

Counterpart of turkish_asr_tpu/audio/features.py::log_mel_spectrogram
(:177-275), which matches torchaudio's ``MelSpectrogram(n_fft=400,
hop_length=160, n_mels=80, mel_scale="htk")`` (power 2, center=True,
reflect padding, periodic Hann) -> ``AmplitudeToDB(top_db=80)`` ->
per-utterance CMVN with the unbiased std.

The STFT is framing followed by one fp32 matmul with a windowed-DFT matrix,
then one fp32 matmul with the mel filterbank; both run at full fp32 (no
TF32), as the JAX package runs them at 'highest' precision. Padded batches
reflect-pad each utterance against its true length, so a padded row gives
the features of the unpadded utterance.
"""

import math
from functools import lru_cache

import numpy as np
import torch


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(n_freqs, n_mels=80, sample_rate=16000, f_min=0.0, f_max=8000.0):
    """HTK-scale triangular mel filterbank, no normalization, (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@lru_cache(maxsize=8)
def _windowed_dft_matrix(n_fft, win_length):
    """(n_fft, 2 * n_bins) matrix giving [Re | -Im] of the windowed rFFT."""
    n_bins = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    if win_length < n_fft:  # torchaudio centers the window in the FFT frame
        pad = (n_fft - win_length) // 2
        w = np.zeros(n_fft)
        w[pad:pad + win_length] = window
    else:
        w = window
    j = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * j * k / n_fft
    return np.concatenate([np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]],
                          axis=1).astype(np.float32)


def _reflect_padded(x, lengths, n_frames, n_fft, hop_length):
    """n_fft // 2 reflected samples written on each side of every row,
    against its true length; the tail is zero-padded.

    Right edge: ``buf[half + L + j] = x[start + half - 1 - j]`` with
    ``start = max(L - 1 - half, 0)``, i.e. ``x[L - 2 - j]`` whenever the row
    holds more than ``half`` samples (the JAX version's dynamic slice).
    """
    B, S = x.shape
    half = n_fft // 2
    n_chunks = -(-n_fft // hop_length)
    pad_to = hop_length * (n_frames + n_chunks)
    buf = torch.nn.functional.pad(x, (half, pad_to - S - half))
    buf[:, :half] = x[:, 1:half + 1].flip(-1)
    L = lengths.to(torch.int64)[:, None]
    j = torch.arange(half, device=x.device)[None, :]
    start = torch.clamp(L - 1 - half, min=0)
    src = x.gather(1, (start + half - 1 - j).expand(B, half))
    buf.scatter_(1, (half + L + j).expand(B, half), src)
    return buf


def _frame_indices_reflect(n_frames, n_samples, lengths, n_fft, hop_length, device):
    """(B, n_frames, n_fft) sample indices with one reflection fold per side,
    clamped to the buffer (the gather path for inputs of at most n_fft
    samples)."""
    t = torch.arange(n_frames, device=device)[:, None]
    j = torch.arange(n_fft, device=device)[None, :]
    p = (t * hop_length + j - n_fft // 2).abs()[None]
    L = lengths.to(torch.int64)[:, None, None]
    p = torch.where(p >= L, 2 * (L - 1) - p, p)
    return torch.clamp(p, 0, n_samples - 1)


def log_mel_spectrogram(waveform, lengths=None, *, n_fft=400, hop_length=160,
                        win_length=400, n_mels=80, sample_rate=16000, f_min=0.0,
                        f_max=8000.0, top_db=80.0, normalize=True):
    """Log-mel features, CMVN-normalized by default.

    Args:
        waveform: (S,) or (B, S) float32 tensor.
        lengths: optional (B,) true sample counts of a padded batch.

    Returns:
        (T, n_mels) for a single input; ((B, T, n_mels), (B,) int32 valid
        frame counts) for a batch. T = 1 + S // hop_length; frames past a
        row's valid count are zero.
    """
    single = waveform.dim() == 1
    x = (waveform[None, :] if single else waveform).to(torch.float32)
    B, S = x.shape
    device = x.device
    n_frames = 1 + S // hop_length
    n_bins = n_fft // 2 + 1
    full = torch.full((B,), S, dtype=torch.int64, device=device)
    lens = full if lengths is None else lengths.to(device=device, dtype=torch.int64)

    if S > n_fft:
        buf = _reflect_padded(x, lens, n_frames, n_fft, hop_length)
        frames = buf.unfold(1, n_fft, hop_length)[:, :n_frames]
    else:
        idx = _frame_indices_reflect(n_frames, S, lens, n_fft, hop_length, device)
        frames = x.gather(1, idx.reshape(B, -1)).reshape(B, n_frames, n_fft)

    dft = torch.from_numpy(_windowed_dft_matrix(n_fft, win_length)).to(device)
    fb = torch.from_numpy(mel_filterbank(n_bins, n_mels, sample_rate, f_min, f_max)).to(device)
    spec = torch.matmul(frames, dft)
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel = torch.matmul(power, fb)

    # AmplitudeToDB(stype="power", top_db): clamped below at the row's
    # maximum over valid frames minus top_db.
    log_mel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    frame_lengths = 1 + lens // hop_length
    valid = (torch.arange(n_frames, device=device)[None, :] < frame_lengths[:, None])[..., None]
    max_db = torch.where(valid, log_mel, -math.inf).amax(dim=(1, 2), keepdim=True)
    log_mel = torch.maximum(log_mel, max_db - top_db)

    if normalize:
        n_valid = frame_lengths.to(torch.float32)[:, None, None]
        mean = torch.where(valid, log_mel, 0.0).sum(dim=1, keepdim=True) / n_valid
        sq = torch.where(valid, (log_mel - mean) ** 2, 0.0).sum(dim=1, keepdim=True)
        std = torch.sqrt(sq / torch.clamp(n_valid - 1.0, min=1.0))
        log_mel = (log_mel - mean) / (std + 1e-8)

    log_mel = torch.where(valid, log_mel, 0.0)
    if single:
        return log_mel[0]
    return log_mel, frame_lengths.to(torch.int32)
