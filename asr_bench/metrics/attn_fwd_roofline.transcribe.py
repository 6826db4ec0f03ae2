"""Percent: the frozen bound of the attention forward at each call's shapes over the device time of
everything launched inside that call (profiler, harness span around the op)."""

from asr_bench.readers import roofline


def read(ctx):
    return roofline(ctx, {"attn_fwd": "flash_attention_fwd"})
