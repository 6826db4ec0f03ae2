"""Percent of the samples ASRInference._forward_batch was given that are padding, from the
program's counters ``forward_samples_valid`` and ``forward_samples_padded`` (the set-up's warm-up
included): the program's own count of ``padding_share``."""

from asr_bench.program_spans import recorder


def read(ctx):
    tracing = recorder(ctx)
    if tracing is None:
        return None
    counted = tracing.counters()
    padded = counted.get("forward_samples_padded", 0)
    if not padded:
        return None
    return 100.0 * (1.0 - counted.get("forward_samples_valid", 0) / padded)
