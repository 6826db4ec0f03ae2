"""Percent of the traced stretch's busy device time launched inside the program's ``subsample``
spans (``ConformerCTC.forward``: the 8x subsample and the input projection), by the
profiler and the program's spans; none where the program has no such span."""

from asr_bench.program_spans import spans


def read(ctx):
    got = spans(ctx, "subsample")
    if got is None:
        return None
    busy_us = 1e6 * ctx.trace.busy_s()
    inside = sum(e[2] for _, events in ctx.trace.under(got, "subsample") for e in events)
    return 100.0 * inside / busy_us if busy_us > 0 and inside > 0 else None
