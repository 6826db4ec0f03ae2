"""Profiling hooks for the trainer's ``--profile_dir``.

Counterpart of turkish_asr_tpu/utils/runtime.py. ``start_profiler_trace``
and ``stop_profiler_trace`` wrap ``torch.profiler`` (CPU activity, and
CUDA activity when a card is present) and write a Chrome trace
(``trace_<pid>_<ns>.json``, readable in Perfetto or chrome://tracing)
into the directory; the card's kernels appear in it by their CUDA names
(``flash_fwd_kernel``, ``flash_bwd_dq``, ``flash_bwd_dkdv``,
``ctc_fwd_kernel``, ``ctc_bwd_kernel``).

``enable_compilation_cache`` has no counterpart: nothing here compiles
through XLA, and the port's own kernels are cached by content under
``build/`` (``ops/_build.py``).
"""

import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def start_profiler_trace(profile_dir):
    """Start a torch.profiler trace that ``stop_profiler_trace`` writes
    into ``profile_dir``; returns its handle, or None for no directory."""
    if not profile_dir:
        return None
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof, profile_dir


def stop_profiler_trace(handle):
    """Stop the trace and write it; returns the trace file's path (None
    for no handle)."""
    if not handle:
        return None
    prof, profile_dir = handle
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
