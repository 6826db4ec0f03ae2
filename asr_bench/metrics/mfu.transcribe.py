"""Percent of the card's bf16 dense peak: the frozen forward FLOPs of every utterance transcribed,
at its own length, over the window's seconds."""

from asr_bench.readers import mfu


def read(ctx):
    return mfu(ctx, 1)
