"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at its first use from ``turkish_asr_torch/csrc``
into ``build/turkish_asr_torch/`` at the root of the checkout (git-ignored)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/turkish_asr_torch/lib<name>-<hash>.so <sources>

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. The compiler's output, with the
registers and shared memory ptxas reports for each kernel, is kept beside
the library as ``<name>-<hash>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "turkish_asr_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def find_nvcc():
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from source")
    return found


def library_path(name, sources):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name, sources):
    """The ctypes handle of ``lib<name>``, built from ``csrc/<sources>``
    if no library with the sources' hash exists yet."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        so_path = library_path(name, sources)
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(CSRC_DIR / s) for s in sources]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            so_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        _loaded[name] = lib
        return lib
