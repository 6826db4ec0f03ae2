"""Percent of the samples passed to ASRInference._forward_batch that are padding: its lengths
against its array (harness span)."""


def read(ctx):
    if not ctx.stats.get("padded"):
        return None
    return 100.0 * (1.0 - ctx.stats["samples"] / ctx.stats["padded"])
