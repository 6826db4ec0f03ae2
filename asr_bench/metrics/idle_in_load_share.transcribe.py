"""Percent of the kept stretch's device-idle time that lies inside the program's ``load`` spans: the
card waiting on the host's file decoding (profiler and program spans)."""

from asr_bench.program_spans import idle_share_inside


def read(ctx):
    return idle_share_inside(ctx, "load")
