"""Percent of the kept stretch's device-idle time that lies inside the program's ``forward`` spans:
the card waiting while the host enqueues a batch's launches and copies (profiler and program
spans)."""

from asr_bench.program_spans import idle_share_inside


def read(ctx):
    return idle_share_inside(ctx, "forward")
