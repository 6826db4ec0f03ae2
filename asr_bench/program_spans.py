"""The program's own spans and counters, as the harness's trace reduction
takes them.

The port records spans inside its transcription path while a
``torch.profiler`` session is open (``turkish_asr_torch/utils/tracing.py``),
so a traced run's stretches hold the program's spans of the calls they
traced, on the host clock that ``Trace.offset`` ties to the device trace.
Its counters are always on. This module imports the recorder, and nothing
else of the program, inside its functions.

Every reading is None where the run has no trace, the trace's clocks are
not tied, the program has no recorder (a tree older than it), or no span
or counter of the name asked for holds anything. Times on the trace's clock
are microseconds.

    python -m asr_bench.program_spans --workload <name> --seed <n> --seconds <s>

runs the cell traced, as ``asr_bench/run.py --trace 1`` does, prints its
result line, then on standard error the kept stretch's device-idle seconds
by the innermost program span open (``none`` where none is).
"""

import argparse
import json
import sys

from asr_bench.trace import Spans


def recorder(ctx):
    """The program's recorder module, or None (see above)."""
    t = getattr(ctx, "trace", None)
    if t is None or t.offset is None:
        return None
    try:
        from turkish_asr_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def spans(ctx, name=None):
    """The program's spans (all, or those named ``name``) as a harness
    ``Spans``: items (name, thread ids, start, end, attrs) on the host
    clock; None where there is none."""
    tracing = recorder(ctx)
    if tracing is None:
        return None
    out = Spans()
    out.items = [(s.name, s.tids, s.t0, s.t1, s.attrs) for s in tracing.spans()
                 if name is None or s.name == name]
    return out if out.items else None


def _on_trace(trace, items):
    """[(start, end, name)] of harness-span items on the trace's clock,
    cut to the stretch."""
    out = []
    for name, _, a, b, _ in items:
        a, b = max(a * 1e6 + trace.offset, trace.t0), min(b * 1e6 + trace.offset, trace.t1)
        if b > a:
            out.append((a, b, name))
    return out


def idle_intervals(trace):
    """[(start, end)] of the stretch in which no device operation ran."""
    out, end = [], trace.t0
    for _, ts, dur, _ in trace.device:
        if ts > end:
            out.append((end, min(ts, trace.t1)))
        end = max(end, ts + dur)
    if trace.t1 > end:
        out.append((end, trace.t1))
    return [(a, b) for a, b in out if b > a]


def _covered(intervals, cover):
    """Length of ``intervals`` (sorted, disjoint) inside the union of ``cover``."""
    merged = []
    for a, b in sorted(cover):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total, j = 0.0, 0
    for a, b in intervals:
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            total += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return total


def idle_share_inside(ctx, name):
    """Percent of the kept stretch's device-idle time that lies inside a
    program span ``name``."""
    got = spans(ctx, name)
    if got is None:
        return None
    on = _on_trace(ctx.trace, got.items)
    idle = idle_intervals(ctx.trace)
    total = sum(b - a for a, b in idle)
    if not on or total <= 0:
        return None
    return 100.0 * _covered(idle, [(a, b) for a, b, _ in on]) / total


def idle_by_innermost(trace, items):
    """{span name or "none": seconds of the stretch's device-idle time in
    which that span was the innermost program span open}; ``items`` as a
    ``Spans``'s (one thread's spans nest, so the innermost is the open one
    that began last)."""
    on = _on_trace(trace, items)
    out = {}
    for a, b in idle_intervals(trace):
        cuts = sorted({a, b} | {x for s in on for x in s[:2] if a < x < b})
        for lo, hi in zip(cuts, cuts[1:]):
            open_ = [s for s in on if s[0] <= lo and hi <= s[1]]
            name = max(open_, key=lambda s: s[0])[2] if open_ else "none"
            out[name] = out.get(name, 0.0) + (hi - lo) * 1e-6
    return out


def main(argv=None):
    from asr_bench import common, run

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    bench = common.benchmark()
    cell = run.Cell.named(bench, args.workload, args.seed, args.seconds, trace=True)
    run._environment(cell.mix)
    correct, attempted, failed, metrics, device, rows, breakdown = run.execute(cell, bench)
    print(common.result_line(correct, attempted, failed, metrics, device, rows, breakdown))
    trace = cell.profile.best()
    got = spans(type("Ctx", (), {"trace": trace})())
    if got is None:
        print("asr_bench: no traced stretch with tied clocks and program spans", file=sys.stderr)
        return 1
    idle = idle_by_innermost(trace, got.items)
    print(json.dumps({"idle_s_by_innermost_span": idle, "idle_s": sum(idle.values()),
                      "window_s": trace.window_s}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
