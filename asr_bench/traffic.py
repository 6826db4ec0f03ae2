"""The benchmark's one traffic generator: clips, transcripts and the
order files are asked for, from a mix's parameters and the run's seed.

A mix (``asr_bench/traffic/<mix>.json``) gives its clip lengths as a
distribution:

- ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
- ``{"dist": "uniform", "min": a, "max": b}``

A pool of ``n`` clips takes the distribution's quantiles at (i + 0.5) / n,
clipped to [min, max], in an order drawn from the seed: every seed gets the
same set of lengths, so the work of a run does not move with its seed,
and another order and other samples. The samples are Gaussian noise under
a syllable-rate envelope (about four bursts a second), 16-bit at 16 kHz.
Transcripts are words of random Turkish letters at ``chars_per_s``.
"""

import io
import os
import statistics
import wave

import numpy as np

SR = 16000
LETTERS = "abcçdefgğhıijklmnoöprsştuüvyz"


def rng_of(seed, *stream):
    """A numpy generator for one stream of a run's draws."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def lengths(spec, n, rng):
    """``n`` clip lengths in samples: the distribution's quantiles in an
    order drawn from ``rng``."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(v) for v in q])
        sec = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        sec = spec["min"] + q * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown clip distribution {spec['dist']!r}")
    sec = np.clip(sec, spec["min"], spec["max"])
    return rng.permutation(np.round(sec * SR).astype(np.int64))


def samples(n, rng):
    """``n`` int16 samples of enveloped noise."""
    t = np.arange(n, dtype=np.float32) / SR
    rate = rng.uniform(3.0, 5.0)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
    x = rng.standard_normal(n, dtype=np.float32) * env * rng.uniform(0.05, 0.2)
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")


def wav_bytes(pcm):
    """A 16-bit mono 16 kHz WAV file of ``pcm``."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_file(path, data):
    """Write ``data`` (bytes or str) to ``path``."""
    with open(path, "wb") as f:
        f.write(data.encode("utf-8") if isinstance(data, str) else data)


def flush_to_disk():
    """Flush what set-up wrote to the disk, in one call, so that the
    kernel's write-back of its files does not fall in the measured window."""
    os.sync()


def transcript(n_samples, chars_per_s, rng):
    """Words of 2-8 random Turkish letters, about ``chars_per_s``
    characters a second of audio, spaces included."""
    target = max(1, int(round(chars_per_s * n_samples / SR)))
    words, size = [], 0
    while size < target:
        w = "".join(rng.choice(list(LETTERS), size=int(rng.integers(2, 9))))
        words.append(w)
        size += len(w) + 1
    return " ".join(words)[:target].strip() or "a"


def clip_pool(mix, seed, n=None):
    """The mix's pool of clips: a list of int16 arrays."""
    n = n or mix["pool"]
    rng = rng_of(seed, 1)
    return [samples(int(m), rng) for m in lengths(mix["clip_seconds"], n, rng)]


def choices(n_pool, count, seed, stream=3):
    """``count`` pool indices: the pool in seeded permutations, one after
    another, so every clip is asked for about equally often."""
    rng = rng_of(seed, stream)
    out = []
    while len(out) < count:
        out.extend(rng.permutation(n_pool).tolist())
    return out[:count]
