"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at its first use from ``turkish_asr_torch/csrc``
into ``build/turkish_asr_torch/`` at the root of the checkout (git-ignored)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/turkish_asr_torch/lib<name>-<hash>.so <sources>

The file name carries a hash of the sources, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source is rebuilt and an
unchanged one is reused. The compiler's output, with the registers and
shared memory ptxas reports for each kernel, is kept beside the library as
``<name>-<hash>.log``. ``build_all`` starts one nvcc per library at once,
so a fresh checkout pays for the slowest build, not the sum.
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
    for src in [*sources, *sorted(p.name for p in CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_nvcc(name, sources):
    """(process, temporary output, final path) of a started build, or None
    if the library is built already."""
    so_path = library_path(name, sources)
    if so_path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(CSRC_DIR / s) for s in sources]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so_path


def _finish_nvcc(name, started):
    proc, tmp, so_path = started
    output, _ = proc.communicate()
    so_path.with_suffix(".log").write_text(output)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{output}")
    os.replace(tmp, so_path)


def build_all(libraries):
    """Build every ``{name: sources}`` library that is not built yet, one
    nvcc each, all started together; raises if any build fails."""
    with _lock:
        started = {name: _start_nvcc(name, srcs) for name, srcs in libraries.items()}
        failures = []
        for name, job in started.items():
            if job is None:
                continue
            try:
                _finish_nvcc(name, job)
            except RuntimeError as e:
                failures.append(str(e))
        if failures:
            raise RuntimeError("\n".join(failures))


def load_library(name, sources):
    """The ctypes handle of ``lib<name>``, built from ``csrc/<sources>``
    if no library with the sources' hash exists yet."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        job = _start_nvcc(name, sources)
        if job is not None:
            _finish_nvcc(name, job)
        lib = ctypes.CDLL(str(library_path(name, sources)))
        _loaded[name] = lib
        return lib
