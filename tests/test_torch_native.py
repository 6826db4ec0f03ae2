"""The port's host C++ library through its own loader
(turkish_asr_torch/native/loader.py): the WAV and FLAC decoders import
nothing of the JAX package, build the library under
build/turkish_asr_torch/, and give what the numpy and Python decoders give;
the resampler and the edit distance give the JAX package's results bit for
bit, through the native routines and through their numpy and Python
fallbacks (``TASR_NATIVE=0``); the WAV decoder, the port's own, gives the
bits of the numpy decoder and of the JAX package's in every sample format."""

import json
import math
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from turkish_asr_tpu.audio.wavio import read_wav as jax_read_wav
from turkish_asr_tpu.audio.wavio import resample as jax_resample
from turkish_asr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from turkish_asr_tpu.utils import metrics as jax_metrics
from turkish_asr_torch.audio import wavio
from turkish_asr_torch.data.tokenizer import CharTokenizer
from turkish_asr_torch.native import loader
from turkish_asr_torch.utils import metrics, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

_DECODE = """
import json, os, sys
sys.path.insert(0, {tests!r})
import numpy as np
from flac_util import encode_flac
from turkish_asr_torch.native import loader as native
from turkish_asr_torch.audio.flacio import read_flac, read_flac_bytes
from turkish_asr_torch.audio.wavio import read_wav, write_wav

rng = np.random.default_rng(0)
wav = os.path.join({tmp!r}, "a.wav")
write_wav(wav, (0.3 * rng.standard_normal((2, 4000))).astype(np.float32), 22050)
flac = os.path.join({tmp!r}, "a.flac")
pcm = (rng.standard_normal((1, 5000)) * 3000).astype(np.int64)
data = encode_flac(pcm, 16000, subframe_kinds=["fixed2", "verbatim"])
with open(flac, "wb") as f:
    f.write(data)
lib = native.get_lib()
natively = [native.wav_decode_native(open(wav, "rb").read()) is not None,
            native.flac_decode_native(data) is not None]
got_wav, got_flac = read_wav(wav), read_flac(flac)
os.environ["TASR_NATIVE"] = "0"  # from here on the numpy and Python decoders
want_wav, want_flac = read_wav(wav), read_flac_bytes(data)
print(json.dumps({{
    "lib": None if lib is None else lib._name,
    "natively": natively,
    "wav_equal": bool(np.array_equal(got_wav[0], want_wav[0])) and got_wav[1] == want_wav[1],
    "wav_shape": list(got_wav[0].shape),
    "flac_equal": bool(np.array_equal(got_flac[0], want_flac[0])) and got_flac[1] == want_flac[1],
    "jax_modules": sorted(m for m in sys.modules if m.startswith("turkish_asr_tpu")),
    "src": str(native.SRC),
}}))
"""


def test_decoders_use_the_ports_own_native_library(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "TASR_NATIVE"}
    proc = subprocess.run([sys.executable, "-c", _DECODE.format(tests=TESTS, tmp=str(tmp_path))],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_modules"] == []
    port = os.path.join(ROOT, "turkish_asr_torch") + os.sep
    assert out["src"].startswith(port) and os.path.isfile(out["src"]), out["src"]
    assert out["wav_equal"] and out["wav_shape"] == [2, 4000]
    assert out["flac_equal"]
    if shutil.which("g++"):
        build = os.path.join(ROOT, "build", "turkish_asr_torch") + os.sep
        assert out["lib"] is not None and out["lib"].startswith(build), out["lib"]
        assert os.path.basename(out["lib"]).startswith("libasr_native-")
        assert out["natively"] == [True, True]
    else:
        assert out["lib"] is None and out["natively"] == [False, False]


def _without_wav_section(source):
    """The C++ source from its first line after the port's header, with
    the WAV section (its banner down to the resampler's) cut out."""
    source = source[source.index("// Native host-side hot ops"):]
    start = source.index("// WAV decode\n")
    return source[:start] + source[source.index("// Windowed-sinc", start):]


def test_native_source_is_the_ports_own_copy():
    """The port compiles its own copy of the host C++ decoders, which
    holds the JAX package's source unchanged below its header but for the
    WAV section (``wav_decode``, the port's own: the parametrised test
    below holds it to the numpy decoder and the JAX package's), and no
    file of the port or chip_smoke.py names a path in the JAX package's
    native tree."""
    port = os.path.join(ROOT, "turkish_asr_torch")
    assert os.path.commonpath([str(loader.SRC), port]) == port
    with open(loader.SRC, encoding="utf-8") as f:
        copy = f.read()
    with open(os.path.join(ROOT, "turkish_asr_tpu", "native", "src", "asr_native.cpp"),
              encoding="utf-8") as f:
        original = f.read()
    assert copy.startswith("// Copied into turkish_asr_torch")
    assert original.startswith("// Native host-side hot ops")
    assert _without_wav_section(copy) == _without_wav_section(original)
    assert "int wav_decode(" in copy and "int wav_decode(" in original
    for name in ("int64_t resample_f32(", "int flac_decode(", "int64_t levenshtein_i32("):
        assert name in _without_wav_section(copy), name
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(port):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    for path in files:
        with open(path, encoding="utf-8") as f:
            assert '"turkish_asr_tpu" /' not in f.read(), path


def _chunk(name, body):
    return name + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _wav_bytes(code, bits, channels, frames, seed, extensible=False, truncate=0,
               data_first=False):
    """A WAV file of seeded samples: PCM (code 1) of random bytes over the
    full range, or IEEE float (code 3) of values from 1e-45 to 1e3, and a
    ``LIST`` chunk last; ``extensible`` writes the format as
    WAVE_FORMAT_EXTENSIBLE, ``data_first`` puts ``data`` before ``fmt ``,
    and ``truncate`` leaves out the ``LIST`` chunk and cuts that many bytes
    off the data (the sizes in the headers stay)."""
    rng = np.random.default_rng(seed)
    n = frames * channels
    if code == 1:
        raw = rng.integers(0, 256, n * bits // 8, dtype=np.uint8).tobytes()
    else:
        x = rng.standard_normal(n) * np.exp(rng.uniform(-103.0, 7.0, n))
        raw = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else code, channels, 22050,
                      22050 * align, align, bits)
    if extensible:
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt += struct.pack("<HHIH", 22, bits, (1 << channels) - 1, code) + guid_tail
    chunks = [_chunk(b"fmt ", fmt), _chunk(b"data", raw)]
    if data_first:
        chunks.reverse()
    if not truncate:
        chunks.append(_chunk(b"LIST", b"INFOISFT\x05\x00\x00\x00test\x00"))
    body = b"WAVE" + b"".join(chunks)
    data = b"RIFF" + struct.pack("<I", len(body)) + body
    return data[:len(data) - truncate]


_FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32), (3, 64)]
_WAV_CASES = [pytest.param(dict(code=c, bits=b, channels=ch, frames=1024),
                           id=f"{'pcm' if c == 1 else 'float'}{b}-{ch}ch")
              for c, b in _FORMATS for ch in (1, 2, 3)] + [
    pytest.param(dict(code=1, bits=8, channels=1, frames=2049), id="pcm8-odd-frames"),
    pytest.param(dict(code=1, bits=16, channels=3, frames=777), id="pcm16-3ch-odd-frames"),
    pytest.param(dict(code=1, bits=16, channels=1, frames=1), id="pcm16-one-frame"),
    pytest.param(dict(code=3, bits=64, channels=2, frames=1), id="float64-2ch-one-frame"),
    pytest.param(dict(code=1, bits=24, channels=2, frames=1000, extensible=True),
                 id="pcm24-2ch-extensible"),
    pytest.param(dict(code=3, bits=32, channels=1, frames=1000, extensible=True),
                 id="float32-extensible"),
    pytest.param(dict(code=1, bits=16, channels=2, frames=1000, truncate=2),
                 id="pcm16-2ch-truncated-mid-frame"),
    pytest.param(dict(code=1, bits=24, channels=1, frames=1000, truncate=301),
                 id="pcm24-truncated"),
    pytest.param(dict(code=3, bits=32, channels=2, frames=1000, data_first=True),
                 id="float32-2ch-data-before-fmt"),
]


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("case", _WAV_CASES)
def test_wav_decoder_gives_the_numpy_and_jax_bits(tmp_path, monkeypatch, case):
    """The port's native ``wav_decode`` gives, bit for bit and at the same
    rate, what the numpy branch of ``read_wav`` (``TASR_NATIVE=0``) and the
    JAX package's ``read_wav`` give (through its own native library, built
    from the original decoder, and through its numpy branch)."""
    data = _wav_bytes(seed=0, **case)
    path = tmp_path / "a.wav"
    path.write_bytes(data)
    native = loader.wav_decode_native(data)
    if shutil.which("g++"):
        assert native is not None
    jax_native = jax_read_wav(str(path))
    monkeypatch.setenv("TASR_NATIVE", "0")
    assert loader.wav_decode_native(data) is None
    want, want_rate = wavio.read_wav(str(path))
    jax_numpy = jax_read_wav(str(path))
    frame_bytes = case["channels"] * case["bits"] // 8
    frames = case["frames"] - math.ceil(case.get("truncate", 0) / frame_bytes)
    assert want.dtype == np.float32 and want.shape == (case["channels"], frames)
    for got, rate in [r for r in (native, jax_native, jax_numpy) if r is not None]:
        assert rate == want_rate == 22050
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_read_wav_counts_the_route_it_took(tmp_path, monkeypatch, route):
    """Each WAV decoded adds 1 to ``wav_decode_native`` when the library
    decoded it and to ``wav_decode_numpy`` when the numpy branch did."""
    if route == "native" and not shutil.which("g++"):
        pytest.skip("no g++: the native library cannot be built")
    if route == "numpy":
        monkeypatch.setenv("TASR_NATIVE", "0")
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, np.zeros((1, 160), np.float32), 16000)
    other = {"native": "numpy", "numpy": "native"}[route]
    before = tracing.counters()
    wavio.read_wav(path)
    after = tracing.counters()
    delta = {k: after.get(f"wav_decode_{k}", 0) - before.get(f"wav_decode_{k}", 0)
             for k in (route, other)}
    assert delta == {route: 1, other: 0}


@pytest.mark.parametrize("orig,new,route", [(44100, 16000, "native"), (8000, 16000, "native"),
                                            (16000, 14545, "taps"), (16000, 17777, "taps")])
def test_resample_equals_the_jax_package_bit_for_bit(monkeypatch, orig, new, route):
    """Both packages load their native library (the same source, the same
    g++ flags). The port calls its native routine where the routine's
    polyphase bank is small, and otherwise sums the same float64 products
    over the taps in support (16000 -> 14545 and 17777, the speed
    perturbation's ratios, where the JAX package's native routine builds a
    75 MB and a 2.3 GB bank): the bits are the same."""
    calls = []
    real = loader.resample_native

    def counted(*args):
        calls.append(args[1:3])
        return real(*args)

    monkeypatch.setattr(loader, "resample_native", counted)
    x = (0.3 * np.random.default_rng(orig + new).standard_normal(orig // 2)).astype(np.float32)
    got = wavio.resample(x, orig, new)
    want = jax_resample(x, orig, new)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if shutil.which("g++"):
        assert calls == ([(orig, new)] if route == "native" else [])
    stereo = wavio.resample(np.stack([x, -x]), orig, new)
    np.testing.assert_array_equal(stereo, np.stack([got, -got]))


def test_without_the_library_resample_takes_the_numpy_sum(monkeypatch):
    """``TASR_NATIVE=0``: every native function gives None, and ``resample``
    sums in numpy, to the native routine's bits and within 1e-5 of the JAX
    package's numpy fallback (float32 products in another order)."""
    x = (0.3 * np.random.default_rng(1).standard_normal(44100)).astype(np.float32)
    native = wavio.resample(x, 44100, 16000)
    monkeypatch.setenv("TASR_NATIVE", "0")
    assert loader.get_lib() is None and not loader.native_available()
    assert loader.resample_native(x, 44100, 16000) is None
    assert loader.levenshtein_native([1, 2], [2]) is None
    assert loader.wav_decode_native(b"RIFF") is None
    got = wavio.resample(x, 44100, 16000)
    np.testing.assert_array_equal(got, native)
    np.testing.assert_allclose(got, jax_resample(x, 44100, 16000), rtol=0, atol=1e-5)


def _ids(rng, n, vocab):
    return [int(v) for v in rng.integers(0, vocab, n)]


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "dp"])
def test_edit_distance_and_metrics_equal_the_jax_package(monkeypatch, native):
    """On 200 seeded pairs of token lists (ids and words) the port's edit
    distance equals the JAX package's and the two-row DP, and
    ``ASRMetrics.compute_from_ids`` gives the JAX metrics' WER, CER and
    strings, through the native Levenshtein and through the DP."""
    monkeypatch.setenv("TASR_NATIVE", native)
    if native == "1" and shutil.which("g++"):
        assert loader.native_available()
    rng = np.random.default_rng(0)
    words = ["bir", "iki", "üç", "dört", "beş", "altı"]
    for _ in range(200):
        a, b = _ids(rng, rng.integers(0, 30), 8), _ids(rng, rng.integers(0, 30), 8)
        d = metrics._edit_distance(a, b)
        assert d == jax_metrics._edit_distance(a, b) == metrics._levenshtein_dp(a, b)
        wa, wb = [words[i % 6] for i in a], [words[i % 6] for i in b]
        assert metrics._edit_distance(wa, wb) == jax_metrics._edit_distance(wa, wb)
    tok, jax_tok = CharTokenizer(), JaxCharTokenizer()
    pred = rng.integers(2, tok.vocab_size, (6, 40))
    counts = rng.integers(0, 41, 6)
    targets = np.where(rng.random((6, 32)) < 0.2, 0, rng.integers(2, tok.vocab_size, (6, 32)))
    got = metrics.ASRMetrics(tok).compute_from_ids(pred, counts, targets)
    want = jax_metrics.ASRMetrics(jax_tok).compute_from_ids(pred, counts, targets)
    assert got == want
