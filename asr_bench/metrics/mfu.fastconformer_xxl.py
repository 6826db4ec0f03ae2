"""Percent of the card's bf16 dense peak: the frozen forward FLOPs of FastConformer XXL
(``asr_bench/fastconformer_counts.py``) of every utterance transcribed, at its own length, over
the window's seconds."""

from asr_bench import fastconformer_counts, frozen


def read(ctx):
    if ctx.peak_flops is None or not ctx.stats.get("utterance_samples"):
        return None
    flops = sum(fastconformer_counts.forward_flops(ctx.cfg, n / frozen.SR)
                for n in ctx.stats["utterance_samples"])
    return 100.0 * flops / (ctx.stats["window_s"] * ctx.peak_flops)
