"""Times WAV loading of one checkout on the host: ``audio/wavio.py::load_audio``
through the native decoder and through the numpy one, and the native decode
alone.

Usage (by path, so that ``--root`` picks the package it times):

    python turkish_asr_torch/scripts/ab_wav.py [--root DIR]

``--root`` is the root of a checkout of this repository (default: the one
this file is in); its ``turkish_asr_torch`` is imported and its host library
is built there. Two trees compare in one call on one host: a parent commit
unpacked with ``git archive`` into a git-ignored directory, then parent, this
tree, this tree, parent.

The files are the batch-transcription mix: ``FILES`` 16-bit mono 16 kHz
WAVs of enveloped noise, their lengths the quantiles of a uniform 16-32 s,
written once into a temporary directory (read back from the page cache). For
each route it makes ``REPEATS`` passes of ``load_audio`` over all files,
holding a pass's waveforms until the pass ends as
``ASRInference.transcribe_files`` does, and prints the best and the median
pass as ms for the files and ms per audio second; then the same for the file
reads alone (``open().read()``) and for ``native/loader.py::wav_decode_native``
alone on the bytes already read (a fresh output array a file, as
``read_wav`` makes), once dropping each array at once (so the allocator
hands the same pages back) and once holding them (fresh pages a file). The
native route's ``tracing.counters()`` delta follows where the checkout counts
its routes (``wav_decode_native``, ``wav_decode_numpy``). The last line is a
JSON object of all numbers.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

SR = 16000
FILES = 64  # a call's files in the benchmark's batch-transcription cell
REPEATS = 5


def clip_lengths(n):
    """``n`` lengths in samples: a uniform 16-32 s's quantiles at (i + 0.5) / n."""
    return np.round((16.0 + 16.0 * (np.arange(n) + 0.5) / n) * SR).astype(np.int64)


def write_files(directory, n, seed=0):
    """``n`` WAVs under ``directory``; returns (paths, audio seconds)."""
    rng = np.random.default_rng(seed)
    paths = []
    lengths = clip_lengths(n)
    for i, m in enumerate(lengths):
        t = np.arange(m, dtype=np.float32) / SR
        env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t)
        x = rng.standard_normal(m, dtype=np.float32) * env * 0.1
        pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
        path = os.path.join(directory, f"clip_{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        paths.append(path)
    return paths, float(lengths.sum()) / SR


def passes(fn, items, repeats, hold=True):
    """ms of each of ``repeats`` passes of ``fn`` over ``items``; with
    ``hold`` a pass keeps its results until it ends."""
    out = []
    for _ in range(repeats):
        kept = []
        t0 = time.perf_counter()
        for item in items:
            r = fn(item)
            if hold:
                kept.append(r)
        out.append(1e3 * (time.perf_counter() - t0))
        del kept
    return out


def summary(label, ms, audio_s):
    best, median = min(ms), statistics.median(ms)
    r = {"best_ms": best, "median_ms": median, "best_ms_per_audio_s": best / audio_s,
         "median_ms_per_audio_s": median / audio_s, "passes_ms": ms}
    print(f"{label}: best {best:.2f} ms ({r['best_ms_per_audio_s']:.4f} ms/audio_s), "
          f"median {median:.2f} ms ({r['median_ms_per_audio_s']:.4f} ms/audio_s)", flush=True)
    return r


def host():
    """The host's CPU model and the cores this process may use."""
    model = None
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    return {"cpu": model, "cores": len(os.sched_getaffinity(0))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose turkish_asr_torch is timed")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from turkish_asr_torch.audio import wavio
    from turkish_asr_torch.native import loader
    from turkish_asr_torch.utils import tracing
    if not Path(wavio.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {wavio.__file__}, not the checkout at {root}; run this "
                           f"file by its path, not with -m")
    os.environ.pop("TASR_NATIVE", None)
    if not loader.native_available():
        raise RuntimeError("the checkout's native library did not build or load (g++?)")
    result = {"root": str(root), "host": host(), "library": loader.library_path().name,
              "files": FILES, "repeats": REPEATS}
    print(f"checkout {root}; library {result['library']}; host {result['host']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="ab_wav_") as tmp:
        paths, audio_s = write_files(tmp, FILES)
        result["audio_s"] = audio_s
        print(f"{len(paths)} files, {audio_s:.1f} audio s", flush=True)
        wavio.load_audio(paths[0])  # builds the library once, outside every pass

        names = ("wav_decode_native", "wav_decode_numpy")
        before = tracing.counters()
        ms = passes(wavio.load_audio, paths, REPEATS)
        after = tracing.counters()
        result["counters_native_route"] = {k: after.get(k, 0) - before.get(k, 0) for k in names}
        result["load_audio_native"] = summary("load_audio, native, held", ms, audio_s)
        print(f"counters over the native passes: {result['counters_native_route']} "
              f"({REPEATS * len(paths)} files loaded)", flush=True)

        os.environ["TASR_NATIVE"] = "0"
        try:
            ms = passes(wavio.load_audio, paths, REPEATS)
        finally:
            os.environ.pop("TASR_NATIVE", None)
        result["load_audio_numpy"] = summary("load_audio, numpy (TASR_NATIVE=0), held", ms,
                                             audio_s)

        def read(path):
            with open(path, "rb") as f:
                return f.read()

        result["read_only"] = summary("file reads alone", passes(read, paths, REPEATS),
                                      audio_s)
        blobs = [read(p) for p in paths]
        for hold in (False, True):
            ms = passes(loader.wav_decode_native, blobs, REPEATS, hold)
            result["decode_only_held" if hold else "decode_only"] = summary(
                f"native wav_decode alone, {'held' if hold else 'dropped'}", ms, audio_s)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
