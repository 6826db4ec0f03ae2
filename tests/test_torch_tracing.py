"""The port's recorder of spans and counters (``turkish_asr_torch/utils/tracing.py``) on the
transcription path, on the CPU: spans only while a profiler is open or recording is forced,
their tree, clock and thread ids, the bounded store, and the counters, which are always on.

The checkpoint and the WAVs are ``tests/test_torch_serve.py``'s (d_model 64, 2 blocks).
"""

import os
import sys
import threading
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from asr_bench.trace import thread_ids  # noqa: E402
from test_torch_serve import model_pt, wavs  # noqa: E402,F401 — the shared fixtures
from turkish_asr_torch.inference import ASRInference  # noqa: E402
from turkish_asr_torch.utils import tracing  # noqa: E402

LAUNCH_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd", "dropout_mask", "ctc_fwd",
                   "ctc_bwd", "swiglu_fwd", "bias_act")
N_BLOCKS = 2  # the shared checkpoint's


@pytest.fixture(scope="module")
def asr(model_pt):  # noqa: F811
    return ASRInference(model_pt, device="cpu", compute_dtype=torch.float32)


@pytest.fixture
def files(wavs):  # noqa: F811
    # a 1 s file twice and a 2.5 s file: two buckets
    return [wavs["one"], wavs["two_half"], wavs["one"]]


def _call(asr, files, batch_size):
    """(spans that began and ended inside the call, counters' deltas, start, end)."""
    before = tracing.counters()
    start = time.perf_counter()
    asr.transcribe_files(files, batch_size=batch_size)
    end = time.perf_counter()
    after = tracing.counters()
    inside = [s for s in tracing.spans() if start <= s.t0 and s.t1 <= end]
    return inside, {k: after[k] - before.get(k, 0) for k in after}, start, end


def test_without_a_profiler_no_span_is_recorded_but_the_counters_count(asr, files):
    assert tracing.span("x") is tracing.span("y")  # the one shared context
    spans, delta, _, _ = _call(asr, files, 2)
    assert spans == []
    # two batches of 2 rows, the 1 s bucket's and the 4 s one's; a padding row is one sample
    assert delta["forward_samples_padded"] == 2 * 16000 + 2 * 64000
    assert delta["forward_samples_valid"] == 16000 + 40000 + 16000 + 1


@pytest.mark.parametrize("how", ["profiler", "forced"])
@pytest.mark.parametrize("batch_size,batches", [(1, 3), (2, 2)])
def test_a_traced_call_records_its_tree(asr, files, batch_size, batches, how):
    if how == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            spans, delta, start, end = _call(asr, files, batch_size)
    else:
        was = tracing.record(True)
        try:
            spans, delta, start, end = _call(asr, files, batch_size)
        finally:
            tracing.record(was)
    by_id = {s.id: s for s in spans}
    named = {}
    for s in spans:
        named.setdefault(s.name, []).append(s)
    (root,) = named["transcribe_files"]
    assert root.parent is None and root.attrs == {"files": 3, "batch_size": batch_size}
    assert all(s.root == root.id for s in spans)
    # a file loads, and the next batch is staged, while the batch before it is on the device
    parent_of = {"load": ("transcribe_files", "batch"), "stage": ("transcribe_files", "batch"),
                 "batch": ("transcribe_files",), "forward": ("batch",), "h2d": ("forward",),
                 "attn_fwd": ("forward",), "decode": ("batch",), "d2h_wait": ("decode",)}
    for name, parents in parent_of.items():
        assert all(by_id[s.parent].name in parents for s in named[name]), name
    assert len(named["load"]) == 3
    assert sorted(s.attrs["samples"] for s in named["load"]) == [16000, 16000, 40000]
    assert sum(by_id[s.parent].name == "batch" for s in named["load"]) == \
        delta["load_behind_forward"] == (2 if batch_size == 1 else 0)
    for name in ("stage", "batch", "forward", "h2d", "decode", "d2h_wait"):
        assert len(named[name]) == batches, name
    assert sum(s.attrs["rows"] for s in named["batch"]) == 3
    assert [s.attrs for s in named["stage"]] == [s.attrs for s in named["batch"]]
    assert len(named["attn_fwd"]) == N_BLOCKS * batches
    assert {s.attrs["dtype"] for s in named["attn_fwd"]} == {"fp32"}
    # the forward spans' shapes are what the counters counted
    assert sum(s.attrs["B"] * s.attrs["S"] for s in named["forward"]) == \
        delta["forward_samples_padded"]
    padding_rows = sum(batch_size - s.attrs["rows"] for s in named["batch"])
    assert sum(s.attrs["samples"] for s in named["load"]) + padding_rows == \
        delta["forward_samples_valid"]
    # perf_counter readings inside the call, each child inside its parent
    for s in spans:
        assert start <= s.t0 <= s.t1 <= end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    assert {s.tids for s in spans} == {thread_ids()}


def test_a_thread_records_its_own_ids_and_tree():
    rec = tracing.Recorder()
    rec.record(True)
    got = {}

    def work():
        with rec.span("outer", k=1):
            with rec.span("inner") as inner:
                inner.set(n=2)
        got["ids"] = thread_ids()

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    inner, outer = rec.spans()
    assert (outer.name, outer.parent, outer.root, outer.attrs) == ("outer", None, outer.id,
                                                                  {"k": 1})
    assert (inner.name, inner.parent, inner.root, inner.attrs) == ("inner", outer.id, outer.id,
                                                                  {"n": 2})
    assert inner.tids == outer.tids == got["ids"] != thread_ids()


def test_the_store_drops_its_oldest_spans_at_its_bound():
    rec = tracing.Recorder(max_spans=3)
    assert rec.record(True) is False and rec.record(True) is True
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"]
    rec.record(False)
    with rec.span("off"):
        pass
    assert len(rec.spans()) == 3


def test_counters_count_and_reset():
    rec = tracing.Recorder()
    rec.count("a", 0)
    rec.count("b", 3)
    rec.count("b")
    snapshot = rec.counters()
    rec.count("a", 2)
    assert snapshot == {"a": 0, "b": 4} and rec.counters() == {"a": 2, "b": 4}
    rec.reset_counters("b")
    assert rec.counters() == {"a": 2, "b": 0}
    rec.reset_counters()
    assert rec.counters() == {"a": 0, "b": 0}


@pytest.mark.parametrize("name", LAUNCH_COUNTERS)
def test_kernel_launch_counters_read_through_the_registry(name):
    """The kernel wrappers' counters exist once their modules load; the CPU
    path launches no kernel."""
    import turkish_asr_torch.ops.bias_act  # noqa: F401
    import turkish_asr_torch.ops.ctc  # noqa: F401
    import turkish_asr_torch.ops.flash_attention  # noqa: F401
    import turkish_asr_torch.ops.swiglu  # noqa: F401

    assert tracing.counters()[name] == 0
