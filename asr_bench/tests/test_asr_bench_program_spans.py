"""The readers of the program's own spans and counters (``asr_bench/program_spans.py`` and the
metrics that use it), on a hand-built device trace and hand-made program spans."""

import sys

import pytest

from asr_bench import common, frozen, program_spans, trace
from turkish_asr_torch.utils import tracing
from turkish_asr_torch.utils.tracing import Span

READERS = ("load_ms_per_audio_s.transcribe", "idle_in_load_share.transcribe",
           "idle_in_forward_share.transcribe", "decode_wait_ms.transcribe",
           "padding_share_counted.transcribe", "attn_fwd_roofline_span.transcribe")
ATTN = {"B": 1, "H": 4, "Kh": 1, "T": 8, "D": 64, "dtype": "bf16"}
MAIN, OTHER = (92, 2), (93, 1)


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts,
            "args": {"correlation": corr}}


def _trace(markers=True):
    """Host seconds 10.0 .. 10.001 on trace microseconds 5000 .. 6000; the card busy 5200-5400
    (the attention kernel and a GEMM, launched on thread 2) and 5500-5700; idle 600 us."""
    events = [_launch(2, 5150, 2), _kernel("flash_fwd_kernel", 5200, 100, 2),
              _launch(2, 5160, 3), _kernel("nvjet_gemm", 5300, 100, 3),
              _launch(1, 5400, 4), _kernel("elementwise_kernel", 5500, 200, 4)]
    if markers:
        events += [_launch(1, 5000, 1), _kernel("spin_kernel", 5001, 1, 1),
                   _launch(1, 6000, 5), _kernel("spin_kernel", 6001, 1, 5)]
    return trace.Trace(events, 10.0, 10.001)


def _at(us):
    """The host clock at trace microsecond ``us``."""
    return 10.0 + (us - 5000) * 1e-6


# (id, parent, name, start, end on the trace's clock, attrs), in the order they end
SPANS = [Span(i, parent, 1, name, _at(a), _at(b), MAIN, attrs)
         for i, parent, name, a, b, attrs in (
             (2, 1, "load", 5000, 5100, {"samples": 16000}),
             (3, 1, "load", 5100, 5140, {"samples": 8000}),
             (5, 4, "attn_fwd", 5149.5, 5165, ATTN),
             (4, 1, "forward", 5140, 5450, {"B": 2, "S": 16000}),
             (7, 6, "d2h_wait", 5500, 5800, {}),
             (6, 1, "decode", 5450, 5900, {}),
             (1, None, "transcribe_files", 5000, 5950, {"files": 2, "batch_size": 2}))]


def _ctx(t):
    return type("Ctx", (), {"trace": t, "spans": trace.Spans(), "stats": {}})()


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))
    monkeypatch.setattr(tracing, "counters", lambda: {"forward_samples_valid": 3,
                                                      "forward_samples_padded": 4})


def read(name, ctx):
    return common.load_module("metrics", name).read(ctx)


def test_the_readers_give_the_known_values(program):
    ctx = _ctx(_trace())
    assert ctx.trace.offset is not None
    assert read("load_ms_per_audio_s.transcribe", ctx) == pytest.approx(0.14 / 1.5)
    assert read("idle_in_load_share.transcribe", ctx) == pytest.approx(100 * 140 / 600)
    # 5140-5200 and 5400-5450
    assert read("idle_in_forward_share.transcribe", ctx) == pytest.approx(100 * 110 / 600)
    assert read("decode_wait_ms.transcribe", ctx) == pytest.approx(0.3)
    assert read("padding_share_counted.transcribe", ctx) == pytest.approx(25.0)
    bound = frozen.kernel_bounds("flash_attention_fwd", **ATTN)["bound_ms"]
    # the span holds both launches on its thread: 200 us of device time
    assert read("attn_fwd_roofline_span.transcribe", ctx) == pytest.approx(
        100.0 * bound * 1e3 / 200.0)


def test_idle_time_by_the_innermost_span(program):
    t = _trace()
    got = program_spans.spans(_ctx(t))
    split = program_spans.idle_by_innermost(t, got.items)
    want = {"load": 140, "attn_fwd": 15.5, "forward": 44.5 + 50, "decode": 50 + 100,
            "d2h_wait": 100, "transcribe_files": 50, "none": 50}
    assert set(split) == set(want)
    for name, us in want.items():
        assert split[name] == pytest.approx(us * 1e-6, abs=1e-9), name
    assert sum(split.values()) == pytest.approx(t.window_s - t.busy_s())


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace_or_tied_clocks(program, name):
    assert read(name, _ctx(None)) is None
    untied = _trace(markers=False)
    assert untied.offset is None and read(name, _ctx(untied)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_programs_recorder(monkeypatch, name):
    """An older program, which has no recorder."""
    import turkish_asr_torch.utils

    monkeypatch.delattr(turkish_asr_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "turkish_asr_torch.utils.tracing", None)
    assert read(name, _ctx(_trace())) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_nothing_was_recorded(monkeypatch, name):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert read(name, _ctx(_trace())) is None


def test_a_span_on_another_thread_claims_no_launch(program, monkeypatch):
    """The roofline twin ties kernels to the span's own thread, as Trace.under does."""
    other = [s._replace(tids=OTHER) if s.name == "attn_fwd" else s for s in SPANS]
    monkeypatch.setattr(tracing, "spans", lambda: other)
    ctx = _ctx(_trace())
    # thread 1 launched nothing inside the span
    assert read("attn_fwd_roofline_span.transcribe", ctx) is None
