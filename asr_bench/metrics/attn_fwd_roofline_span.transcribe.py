"""Percent: the frozen bound of the attention forward at each call's shapes over the device time of
everything launched inside that call, the calls marked by the program's own ``attn_fwd`` spans
(profiler and program spans)."""

from asr_bench.program_spans import spans
from asr_bench.readers import roofline


def read(ctx):
    got = spans(ctx, "attn_fwd")
    if got is None:
        return None
    program = type("Ctx", (), {"trace": ctx.trace, "spans": got})()
    return roofline(program, {"attn_fwd": "flash_attention_fwd"})
