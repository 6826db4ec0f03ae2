"""Milliseconds of the program's ``load`` spans (a file read and decoded by ASRInference) per second
of the audio they decoded, over the traced stretches (program spans)."""

from asr_bench import frozen
from asr_bench.program_spans import spans


def read(ctx):
    got = spans(ctx, "load")
    if got is None:
        return None
    loaded = [(b - a, attrs["samples"]) for _, _, a, b, attrs in got.items if "samples" in attrs]
    audio_s = sum(n for _, n in loaded) / frozen.SR
    return 1e3 * sum(d for d, _ in loaded) / audio_s if audio_s > 0 else None
