"""Percent of the traced window with no device operation running (profiler)."""

from asr_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
