# Copied from turkish_asr_tpu/audio/wavio.py; only the imports, the form of the
# reference-file citations and ``resample`` differ. The JAX package's own __init__
# files import JAX, so this jax-free host module cannot be imported from there.
"""Host-side audio I/O: RIFF/WAVE decode and windowed-sinc resampling.

The reference delegates these to torchaudio's C++ ops
(reference data/preprocessing.py:66-79). torchaudio is not a
dependency here; this module implements the same contract in numpy:

- ``read_wav``: PCM 8/16/24/32-bit and IEEE-float WAV decode -> float32
  in [-1, 1], shape (channels, samples).
- ``resample``: windowed-sinc polyphase resampling with the same
  parameterization torchaudio uses by default (lowpass_filter_width=6,
  rolloff=0.99, Hann window), so speed-perturbation and sample-rate
  conversion behave like the reference pipeline.
- ``load_audio``: load + mono-mix + resample to target rate (the
  ``AudioPreprocessor.load_audio`` contract).

A faster C++ implementation is slotted in via
``turkish_asr_torch.native`` — this numpy path is the always-available
fallback and the correctness oracle.
"""

import math
import struct
from functools import lru_cache

import numpy as np

TARGET_SAMPLE_RATE = 16000


class UnsupportedFormatError(ValueError):
    """The file's container format is recognized but not decodable in this
    deployment (e.g. mp3 without ffmpeg installed)."""


def sniff_format(head):
    """Identify an audio container from its first bytes.

    Returns one of "wav", "flac", "mp3", "ogg", "m4a", or None.
    """
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF
                              and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    if head[:4] == b"OggS":
        return "ogg"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "m4a"
    return None


@lru_cache(maxsize=1)
def ffmpeg_available():
    import shutil
    return shutil.which("ffmpeg") is not None


def supported_formats():
    """Extensions decodable in THIS deployment. wav/flac are always
    decodable (self-contained decoders, audio/flacio.py +
    native/src/asr_native.cpp); mp3/ogg/m4a need ffmpeg on PATH (the
    serving Dockerfile installs it, like the reference's image —
    reference Dockerfile:6-9)."""
    formats = {".wav", ".flac"}
    if ffmpeg_available():
        formats |= {".mp3", ".ogg", ".m4a"}
    return formats


def _ffmpeg_load(path, target_sample_rate):
    """Decode any ffmpeg-supported file to mono float32 at the target rate
    (ffmpeg's resampler, not the windowed-sinc one — the compressed-format
    path trades bit-parity for coverage, like the reference's
    torchaudio/ffmpeg backend)."""
    import subprocess
    if not ffmpeg_available():
        with open(path, "rb") as f:
            fmt = sniff_format(f.read(16))
        raise UnsupportedFormatError(
            f"{fmt or 'compressed-audio'} decode requires ffmpeg on PATH "
            f"(wav/flac decode is built in): {path}")
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le",
           "-acodec", "pcm_f32le", "-ac", "1",
           "-ar", str(int(target_sample_rate)), "pipe:1"]
    res = subprocess.run(cmd, capture_output=True, timeout=600)
    if res.returncode != 0 or not res.stdout:
        err = res.stderr.decode("utf-8", errors="replace").strip()[:300]
        raise ValueError(f"ffmpeg decode failed for {path}: {err}")
    return np.frombuffer(res.stdout, dtype="<f4").copy()


def read_audio(path):
    """Decode wav or flac -> (float32 (channels, samples), sample_rate).
    Other formats route through load_audio's ffmpeg path (which also
    resamples)."""
    with open(path, "rb") as f:
        head = f.read(16)
    fmt = sniff_format(head)
    if fmt == "flac":
        from turkish_asr_torch.audio.flacio import read_flac
        return read_flac(path)
    return read_wav(path)


def read_wav(path):
    """Decode a RIFF/WAVE file.

    Uses the native C++ decoder (turkish_asr_torch.native) when available,
    with this numpy implementation as the always-available fallback/oracle.

    Returns:
        (waveform, sample_rate): float32 array of shape (channels, samples)
        scaled to [-1, 1], and the file's sample rate.
    """
    with open(path, "rb") as f:
        data = f.read()

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")

    try:
        from turkish_asr_torch.native.loader import wav_decode_native
        native = wav_decode_native(data)
        if native is not None:
            return native
    except ValueError:
        pass  # unsupported-by-native format: fall through to numpy

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_format, n_channels, sample_rate, _, block_align, bits = struct.unpack(
                "<HHIIHH", body[:16]
            )
            # WAVE_FORMAT_EXTENSIBLE carries the real format in the sub-GUID
            if audio_format == 0xFFFE and chunk_size >= 40:
                (audio_format,) = struct.unpack("<H", body[24:26])
            fmt = (audio_format, n_channels, sample_rate, block_align, bits)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")
    audio_format, n_channels, sample_rate, _, bits = fmt

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}: {path}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"Unsupported float bit depth {bits}: {path}")
    else:
        raise ValueError(f"Unsupported WAV format code {audio_format}: {path}")

    if n_channels > 1:
        x = x[: (len(x) // n_channels) * n_channels].reshape(-1, n_channels).T
    else:
        x = x.reshape(1, -1)
    return np.ascontiguousarray(x), sample_rate


def write_wav(path, waveform, sample_rate):
    """Write float32 (channels, samples) or (samples,) to 16-bit PCM WAV."""
    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    n_channels, n_samples = x.shape
    pcm = np.clip(x.T * 32767.0, -32768, 32767).astype("<i2").tobytes()
    byte_rate = sample_rate * n_channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate, byte_rate, n_channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)


# The largest polyphase bank (phases x taps, float64) for which ``resample``
# calls the native routine: 8 MB. The native routine builds its whole bank
# before it sums, which at a speed-perturbation ratio such as 16000 -> 17777
# (gcd 1: 17777 x 16014 weights) is 2.3 GB and seconds of sin and cos a call.
NATIVE_BANK_MAX = 1 << 20


def _resample_taps(x, o, n, lowpass_filter_width, rolloff):
    """(channels, samples) float32 at rates o -> n (reduced by their gcd),
    in the native routine's arithmetic, evaluated only at the taps inside
    the filter's support.

    The native routine (``csrc/host/asr_native.cpp::resample_f32``) computes
    every weight in float64 as below and sums, for output j = h * n + ph, the
    products ``(double) x[h * o + k - width] * w[ph, k]`` over all
    ``2 * width + o`` taps k in ascending order, then rounds once to float32.
    Outside the ``2 * width + 1`` taps around j * o / n the window clips t
    to the filter's edge, where each weight is ~1e-49: adding them moves no
    sum that a tap in support has made nonzero. So the same products,
    added in the same order over the taps in support, give the same bits.
    """
    base = min(o, n) * rolloff
    width = math.ceil(lowpass_filter_width * o / base)
    n_channels, length = x.shape
    ph = np.arange(n)
    first = (ph * o) // n  # the centre tap's input offset within its hop
    k = first[:, None] + np.arange(-width, width + 1)[None, :]  # (phase, tap) input offsets
    t = (-ph / n)[:, None] + k / o
    t = np.clip(t * base, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2.0)
    window = window * window
    tp = t * math.pi
    sinc = np.where(tp == 0.0, 1.0, np.sin(tp) / np.where(tp == 0.0, 1.0, tp))
    kern = sinc * window * (base / o)
    j = np.arange(math.ceil(n * length / o))
    m0 = (j // n) * o + first[j % n]
    kern = kern[j % n]
    acc = np.zeros((n_channels, len(j)))
    for d in range(2 * width + 1):
        m = m0 + (d - width)
        tap = np.where((m >= 0) & (m < length), x[:, np.clip(m, 0, length - 1)], 0.0)
        acc += tap.astype(np.float64) * kern[:, d]
    return acc.astype(np.float32)


def resample(waveform, orig_freq, new_freq, lowpass_filter_width=6, rolloff=0.99):
    """Windowed-sinc resample (channels, samples) float32 -> new rate.

    The filter of torchaudio's default resampler and of the JAX package's
    ``resample`` (Hann-windowed sinc lowpass at min(orig, new) * rolloff,
    in the rates reduced by their gcd). Mono input goes to the native
    routine first (``turkish_asr_torch.native.resample_native``), as in
    the JAX package, where its polyphase bank holds at most
    ``NATIVE_BANK_MAX`` weights. Otherwise, and when the library is
    missing or ``TASR_NATIVE=0``, ``_resample_taps`` sums the same float64
    products over the taps in support only, which gives the native
    routine's bits. The JAX package's numpy fallback builds the whole (n,
    2 * width + o) polyphase bank instead, which for a speed-perturbation
    ratio such as 16000 -> 17777 (gcd 1) is a 1.1 GB table and ~10 s a
    call; its native routine builds the same bank in float64.
    """
    x = np.asarray(waveform, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if orig_freq == new_freq:
        return x[0] if squeeze else x

    g = math.gcd(int(orig_freq), int(new_freq))
    o, n = int(orig_freq) // g, int(new_freq) // g
    width = math.ceil(lowpass_filter_width * o / (min(o, n) * rolloff))
    if x.shape[0] == 1 and n * (2 * width + o) <= NATIVE_BANK_MAX:
        from turkish_asr_torch.native.loader import resample_native
        native = resample_native(x[0], orig_freq, new_freq, lowpass_filter_width, rolloff)
        if native is not None:
            return native if squeeze else native[None, :]
    out = _resample_taps(x, o, n, lowpass_filter_width, rolloff)
    return out[0] if squeeze else out


def load_audio(path, target_sample_rate=TARGET_SAMPLE_RATE):
    """Load audio, mono-mix, resample to target rate.

    Mirrors AudioPreprocessor.load_audio in the reference
    (reference data/preprocessing.py:66-79), which decodes whatever
    torchaudio/ffmpeg handles. Here: wav and flac through the built-in
    decoders + windowed-sinc resampler; mp3/ogg/m4a (and anything else
    recognizable) through ffmpeg when installed, raising
    UnsupportedFormatError otherwise.

    Returns:
        (waveform, sample_rate): float32 (samples,) mono waveform.
    """
    with open(path, "rb") as f:
        head = f.read(16)
    fmt = sniff_format(head)
    if fmt in ("wav", "flac"):
        x, sr = read_audio(path)
    elif fmt in ("mp3", "ogg", "m4a"):
        return _ffmpeg_load(path, target_sample_rate), target_sample_rate
    elif ffmpeg_available():
        # unrecognized container: let ffmpeg try (reference behavior —
        # torchaudio.load accepts anything its backend can sniff)
        return _ffmpeg_load(path, target_sample_rate), target_sample_rate
    else:
        raise ValueError(f"Unrecognized audio format: {path}")
    if x.shape[0] > 1:
        x = np.mean(x, axis=0, keepdims=True)
    if sr != target_sample_rate:
        x = resample(x, sr, target_sample_rate)
        sr = target_sample_rate
    return x[0], sr
