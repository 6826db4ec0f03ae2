"""The port's WAV and FLAC decoders go through its own native loader
(turkish_asr_torch/audio/native.py): they import nothing of the JAX
package, build the host library under build/turkish_asr_torch/, and give
what the numpy and Python decoders give."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

_DECODE = """
import json, os, sys
sys.path.insert(0, {tests!r})
import numpy as np
from flac_util import encode_flac
from turkish_asr_torch.audio import native
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


def test_native_source_is_the_ports_own_copy():
    """The port compiles its own copy of the host C++ decoders, which
    holds the JAX package's source unchanged below its header, and no
    file of the port or chip_smoke.py names a path in the JAX package's
    native tree."""
    from turkish_asr_torch.audio import native
    port = os.path.join(ROOT, "turkish_asr_torch")
    assert os.path.commonpath([str(native.SRC), port]) == port
    with open(native.SRC, encoding="utf-8") as f:
        copy = f.read()
    with open(os.path.join(ROOT, "turkish_asr_tpu", "native", "src", "asr_native.cpp"),
              encoding="utf-8") as f:
        original = f.read()
    assert copy.endswith(original) and copy.startswith("// Copied into turkish_asr_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(port):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    for path in files:
        with open(path, encoding="utf-8") as f:
            assert '"turkish_asr_tpu" /' not in f.read(), path
