"""Harness spans, and the device trace of a traced run reduced to what the
per-layer metrics read.

Spans are recorded from the benchmark's own files around calls into the
program's layers (``Spans.wrap``): the host clock's start and end, the
thread's ids, and attributes such as shapes. A kernel
belongs to every span that was open, on the thread that launched it, when
it was launched: the trace holds every launch (CUPTI's runtime and driver
callbacks, on every thread) with its thread and host time, and ties each
kernel to its launch by the correlation id. The profiler records the
card's activity only (its CPU-side events come from the thread that
started it alone, and slow the host); a spin kernel launched at each end
of a stretch ties the host clock to the trace's and bounds the window.
On the H100 hosts measured (PERF.md), all but the last profiler session of
a process recorded kernels without times: ``prime`` runs one during set-up,
and the stretch whose kernels carry times is the one read.

``Profile`` traces a short stretch of the window three times, one after
the other, and keeps the one that holds the most timed device events.
Where none holds any, the trace is ``None`` and every metric that reads it
is left out of the line.
With ``ASR_BENCH_TRACE_DIR`` set, each stretch's Chrome trace is kept there,
gzipped.
"""

import bisect
import collections
import functools
import gzip
import json
import os
import shutil
import tempfile
import threading
import time

# Traced runs: the host-side metrics read the first CLEAN_SHARE of the
# window, before the profiler, which slows the host, takes its stretches.
CLEAN_SHARE = 0.6
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def thread_ids():
    """The ids a trace may give this thread: the operating system's, and
    the low 32 bits of the pthread handle (CUPTI's default)."""
    return (threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF)


class Spans:
    """Host spans of the harness: (name, thread ids, start, end, attrs),
    host clock in seconds."""

    def __init__(self):
        self.items = []
        self.tracing = False
        self._lock = threading.Lock()

    def record(self, name, t0, t1, **attrs):
        with self._lock:
            self.items.append((name, thread_ids(), t0, t1, attrs))

    def span(self, name, **attrs):
        return _Span(self, name, attrs)

    def wrap(self, owner, attr, name, attrs_of=None):
        """Replace ``owner.attr`` by a function that records a span around
        each call; ``attrs_of(*args, **kwargs)`` gives its attributes."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name, **(attrs_of(*args, **kwargs) if attrs_of else {})):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        return fn

    def named(self, name):
        return [s for s in self.items if s[0] == name]


class _Span:
    def __init__(self, spans, name, attrs):
        self.spans, self.name, self.attrs = spans, name, attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.record(self.name, self.t0, time.perf_counter(), **self.attrs)
        return False


MARKER = "spin_kernel"
MARKER_SLACK_US = 5000.0


class Trace:
    """One traced stretch: device events and launches, in microseconds of
    the trace's clock, and the stretch's ends. ``wall``: (host clock, wall
    clock in ns) read together at the stretch's start, and the trace's
    ``baseTimeNanoseconds``: where the spin markers are missing, the wall
    clock ties the two clocks instead."""

    def __init__(self, events, t0_host, t1_host, wall=None, base_ns=None):
        self.device = []          # (name, ts, dur, correlation)
        self.launch = {}          # correlation -> (tid, ts)
        markers = []
        for e in events:
            cat, ph = e.get("cat", ""), e.get("ph")
            if ph != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                item = (e["name"], float(e["ts"]), float(e.get("dur", 0)), corr)
                (markers if MARKER in e["name"] else self.device).append(item)
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (e["tid"], float(e["ts"]))
        self.device.sort(key=lambda d: d[1])
        ends = sorted(self.launch[m[3]][1] for m in markers if m[3] in self.launch)
        self.markers = len(ends)
        # trace microseconds = host seconds * 1e6 + offset: from the wall clock,
        # then from a spin marker's launch where one is near where it is due (the
        # profiler may miss either)
        self.offset = None
        if wall is not None and base_ns is not None:
            host, wall_ns = wall
            self.offset = (wall_ns - base_ns) / 1e3 - host * 1e6
        for ts in ends:
            for host in (t0_host, t1_host):
                if self.offset is None or abs(ts - host * 1e6 - self.offset) < MARKER_SLACK_US:
                    self.offset = ts - host * 1e6
                    break
            else:
                continue
            break
        if self.offset is not None:
            self.t0, self.t1 = t0_host * 1e6 + self.offset, t1_host * 1e6 + self.offset
        else:
            self.t0 = self.device[0][1] if self.device else 0.0
            self.t1 = self.device[-1][1] + self.device[-1][2] if self.device else 0.0
        self.window_s = max(self.t1 - self.t0, 0.0) * 1e-6
        self.timed = sum(1 for d in self.device if d[2] > 0)

    def kernels(self):
        """The device events that are kernels (not copies or fills)."""
        return [d for d in self.device if self.is_kernel(d)]

    @staticmethod
    def is_kernel(d):
        return bool(d[0]) and not d[0].startswith(("Memcpy", "Memset"))

    def busy_s(self):
        """Seconds of the window in which a device operation ran (the union
        of their intervals)."""
        busy, end = 0.0, self.t0
        for _, ts, dur, _ in self.device:
            a, b = max(ts, end), min(ts + dur, self.t1)
            if b > a:
                busy += b - a
            end = max(end, min(ts + dur, self.t1))
        return busy * 1e-6

    def _spans(self, spans, name=None):
        """Harness spans inside the stretch, on the trace's clock:
        (name, tid, start, end, attrs)."""
        if self.offset is None:
            return []
        out = []
        for n, tid, a, b, attrs in spans.items:
            a, b = a * 1e6 + self.offset, b * 1e6 + self.offset
            if (name is None or n == name) and a >= self.t0 and b <= self.t1:
                out.append((n, tid, a, b, attrs))
        return out

    def under(self, spans, name):
        """[(attrs, [device events])] for every harness span ``name`` inside
        the stretch: the kernels launched on its thread while it was open
        (on any thread, where the trace names the span's thread by no id
        the harness knows)."""
        by_tid = collections.defaultdict(list)
        for corr, (tid, ts) in self.launch.items():
            by_tid[tid].append((ts, corr))
            by_tid[None].append((ts, corr))
        for v in by_tid.values():
            v.sort()
        events = collections.defaultdict(list)
        for d in self.device:
            if d[3] is not None:
                events[d[3]].append(d)
        out = []
        for _, tids, t0, t1, attrs in self._spans(spans, name):
            tid = next((t for t in tids if t in by_tid), None)
            launches = by_tid[tid]
            i = bisect.bisect_left(launches, (t0, -1))
            got = []
            while i < len(launches) and launches[i][0] <= t1:
                got.extend(events.get(launches[i][1], ()))
                i += 1
            out.append((attrs, got))
        return out

    def breakdown(self, spans, top=10):
        """The device operations that took most time, and the longest idle
        gaps, each gap named by the innermost harness span open then."""
        per_op = collections.Counter()
        for name, ts, dur, _ in self.device:
            per_op[short(name)] += dur * 1e-6
        gaps, end = [], self.t0
        for _, ts, dur, _ in self.device:
            if ts > end:
                gaps.append((ts - end, end))
            end = max(end, ts + dur)
        if self.t1 > end:
            gaps.append((self.t1 - end, end))
        gaps.sort(reverse=True)
        named, inside = [], self._spans(spans)
        for length, at in gaps[:top]:
            open_ = [n for n in inside if n[2] <= at <= n[3]]
            label = min(open_, key=lambda n: n[3] - n[2])[0] if open_ else "none"
            named.append([label, length * 1e-6])
        return {"device_ops": [[k, v] for k, v in per_op.most_common(top)], "idle_gaps": named}


def short(name, width=80):
    """A kernel name cut to its first ``width`` characters."""
    return name if len(name) <= width else name[:width]


def prime():
    """One profiler session of a spin kernel during set-up (see above)."""
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


STRETCHES = 3


class Profile:
    """``STRETCHES`` profiler stretches of the window, the fullest kept."""

    def __init__(self, spans):
        self.spans = spans
        self.traces = []
        self._done = []
        self._prof = None

    def start(self):
        import torch
        self.spans.tracing = True
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._wall = (time.perf_counter(), time.time_ns())
        self._t0 = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self):
        """Close the stretch; its trace is read later (``best``), out of
        the window."""
        import torch
        t1 = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.spans.tracing = False
        self._done.append((self._prof, self._t0, t1, self._wall))
        self._prof = None

    def _read(self):
        keep = os.environ.get("ASR_BENCH_TRACE_DIR")
        for k, (prof, t0, t1, wall) in enumerate(self._done):
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                with open(path) as f:
                    blob = json.load(f)
                events = blob.get("traceEvents", [])
                if keep:
                    os.makedirs(keep, exist_ok=True)
                    with open(path, "rb") as f, gzip.open(
                            os.path.join(keep, f"trace_{len(self.traces) + k}.json.gz"), "wb") as g:
                        shutil.copyfileobj(f, g)
            finally:
                os.unlink(path)
            self.traces.append(Trace(events, t0, t1, wall, blob.get("baseTimeNanoseconds")))
        self._done = []

    def best(self):
        """The stretch with the most timed device events, or None if none
        has any."""
        self._read()
        full = [t for t in self.traces if t.timed]
        return max(full, key=lambda t: t.timed) if full else None


def attention_attrs(q, k, *rest):
    """A span's attributes of an attention call: its shapes and type."""
    B, H, T, D = q.shape
    return {"B": B, "H": H, "Kh": k.shape[1], "T": T, "D": D,
            "dtype": "bf16" if str(q.dtype).endswith("bfloat16") else "fp32"}

