"""The port's loader for the host C++ audio decoders.

Counterpart of turkish_asr_tpu/native/loader.py (``wav_decode_native``,
``flac_decode_native`` :83-133), without importing it. The C++ source is
the port's own copy, ``turkish_asr_torch/csrc/host/asr_native.cpp`` (of
``turkish_asr_tpu/native/src/asr_native.cpp``), compiled at first use
with::

    g++ -O3 -std=c++17 -shared -fPIC -o build/turkish_asr_torch/libasr_native-<hash>.so

at the root of the checkout (git-ignored), the file named by a hash of the
source and the flags as ``ops/_build.py`` names the CUDA libraries. With
no g++, or with ``TASR_NATIVE=0``, ``get_lib`` returns None and the
callers (``audio/wavio.py::read_wav``, ``audio/flacio.py::read_flac``)
run their numpy and Python decoders. Host code, not a TPU kernel.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from turkish_asr_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "asr_native.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libasr_native-{digest.hexdigest()[:16]}.so"


def _build(so_path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib):
    for name in ("wav_decode", "flac_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
    return lib


def get_lib():
    """The loaded CDLL, or None when g++ or the source is missing, the build
    fails, or ``TASR_NATIVE=0``."""
    global _lib, _tried
    if os.environ.get("TASR_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SRC.is_file():
            return None
        so_path = library_path()
        if not so_path.exists() and not _build(so_path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(so_path)))
        except OSError:
            return None
        return _lib


def _decode(name, data):
    """(float32 (channels, samples), sample_rate), None when the library is
    unavailable or the stream needs the Python decoder (rc -5: a FLAC of
    unknown length), ValueError for what the library rejects."""
    lib = get_lib()
    if lib is None:
        return None
    fn = getattr(lib, name)
    n_samples, n_channels, rate = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    sizes = (ctypes.byref(n_samples), ctypes.byref(n_channels), ctypes.byref(rate))
    rc = fn(data, len(data), None, *sizes)
    if rc == -5 and name == "flac_decode":
        return None
    if rc != 0:
        raise ValueError(f"native {name} failed (code {rc})")
    out = np.empty((n_channels.value, n_samples.value), dtype=np.float32)
    rc = fn(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *sizes)
    if rc != 0:
        raise ValueError(f"native {name} failed (code {rc})")
    return out, rate.value


def wav_decode_native(data):
    """WAV bytes -> (float32 (channels, samples), sample_rate) or None."""
    return _decode("wav_decode", data)


def flac_decode_native(data):
    """FLAC bytes -> (float32 (channels, samples), sample_rate) or None."""
    return _decode("flac_decode", data)
