"""Percent: the frozen bound of the relative-position attention at each call's shapes
(``asr_bench/relpos_counts.py``) over the device time of everything launched inside that call, the
calls marked by the program's own ``attn_relpos_fwd`` spans (profiler and program spans)."""

from asr_bench import relpos_counts
from asr_bench.program_spans import spans


def read(ctx):
    got = spans(ctx, "attn_relpos_fwd")
    if got is None:
        return None
    bound_us = device_us = 0.0
    for attrs, events in ctx.trace.under(got, "attn_relpos_fwd"):
        if not events:
            continue
        bound_us += 1e3 * relpos_counts.kernel_bounds(**attrs)["bound_ms"]
        device_us += sum(e[2] for e in events)
    return 100.0 * bound_us / device_us if device_us > 0 else None
