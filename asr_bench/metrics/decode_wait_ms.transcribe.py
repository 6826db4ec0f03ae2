"""Mean milliseconds a batch's decode holds the host in the program's ``d2h_wait`` spans, waiting
for the card's results: how far the card lags the host (program spans)."""

from asr_bench.program_spans import spans


def read(ctx):
    waits, decodes = spans(ctx, "d2h_wait"), spans(ctx, "decode")
    if waits is None or decodes is None:
        return None
    return 1e3 * sum(b - a for _, _, a, b, _ in waits.items) / len(decodes.items)
