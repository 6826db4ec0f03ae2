"""The port's own spans and counters, kept in memory.

Counters (``count``, ``counters``) are always on: named integers under one
lock. The kernel wrappers count their launches here (``flash_attention_fwd``,
``flash_attention_bwd``, ``dropout_mask``, ``ctc_fwd``, ``ctc_bwd``,
``swiglu_fwd``), and ``ASRInference._forward_batch`` the samples it is
given (``forward_samples_valid``) and the padded array's
(``forward_samples_padded``).

Spans (``span``) exist to be laid against a device trace, so they record
only while a ``torch.profiler`` session is open on the calling thread
(``torch.autograd._profiler_enabled()``: a benchmark's traced stretch, the
trainer's ``--profile_dir``), or while ``record(True)`` forces them.
Otherwise ``span`` returns one shared context that does nothing: no clock
read, nothing kept. A recorded span holds its id, its parent's (the span
open on the same thread when it began), its root's (the outermost span open
on that thread: every span of one ``ASRInference.transcribe_files`` call
shares it), its name, start and end on ``time.perf_counter()``, the
thread's ids (the operating system's, and the low 32 bits of the pthread
handle, the id CUPTI gives a launch) and its attributes. The newest
``MAX_SPANS`` are kept.

Spans of the transcription path: ``transcribe_files`` (the root: files,
batch_size), ``load`` (one file decoded: samples), ``batch`` (one padded
batch, from its array until its texts are stored: S, rows), ``forward``
(``_forward_batch``: B, S), ``h2d`` (the copy of waveforms and lengths to
the card), ``attn_fwd`` (``ops.flash_attention._fwd``: B, H, Kh, T, D,
dtype), ``decode`` (the decoder's call) and ``d2h_wait`` (the greedy
decoder's reads of the card).
"""

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

# About 2,000 transcription calls of 64 files (some 130 spans each).
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    root: int
    name: str
    t0: float
    t1: float
    tids: tuple
    attrs: dict


class _Off:
    """The context ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Open:
    """A span being recorded."""

    __slots__ = ("recorder", "name", "attrs", "id", "parent", "root", "t0")

    def __init__(self, recorder, name, attrs):
        self.recorder, self.name, self.attrs = recorder, name, attrs

    def __enter__(self):
        local = self.recorder._thread()
        stack = local.stack
        self.id = next(self.recorder._ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        local = self.recorder._thread()
        local.stack.remove(self)
        span = Span(self.id, self.parent, self.root, self.name, self.t0, t1, local.tids,
                    self.attrs)
        with self.recorder._lock:
            self.recorder._spans.append(span)
        return False

    def set(self, **attrs):
        """Attributes known only inside the span (a file's length once decoded)."""
        self.attrs.update(attrs)


class Recorder:
    """Counters and spans of one process (``RECORDER``); a test may make its own.
    One lock guards the counters and the kept spans."""

    def __init__(self, max_spans=MAX_SPANS):
        self._counters = {}
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=max_spans)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._forced = False

    def count(self, name, n=1):
        """Add ``n`` to counter ``name`` (``n=0`` makes it exist at 0)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self):
        """A snapshot: {name: count}."""
        with self._lock:
            return dict(self._counters)

    def reset_counters(self, *names):
        """Set the counters ``names`` (every counter, with none given) to 0."""
        with self._lock:
            for name in names or list(self._counters):
                self._counters[name] = 0

    def record(self, on):
        """Force spans to record (``True``) or leave it to the profiler
        (``False``); returns the previous setting."""
        was, self._forced = self._forced, bool(on)
        return was

    def span(self, name, **attrs):
        """A context manager: the span ``name``, recorded as the module's
        docstring says, or the shared context that does nothing."""
        if not (self._forced or torch.autograd._profiler_enabled()):
            return _OFF
        return _Open(self, name, attrs)

    def spans(self):
        """The kept spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
            local.tids = (threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF)
        return local


RECORDER = Recorder()
count = RECORDER.count
counters = RECORDER.counters
reset_counters = RECORDER.reset_counters
record = RECORDER.record
span = RECORDER.span
spans = RECORDER.spans
