"""Static waveform buckets for padded batches.

Copied from turkish_asr_tpu/data/dataset.py:240-268 (only these two names;
the dataset module imports JAX).
"""

from turkish_asr_torch.audio.wavio import TARGET_SAMPLE_RATE

DEFAULT_WAVEFORM_BUCKETS = tuple(
    int(TARGET_SAMPLE_RATE * s) for s in (1, 2, 4, 6, 8, 12, 16, 24, 32)
)


def bucket_table(max_value, buckets):
    """Smallest bucket >= max_value (or the largest bucket if none fits)."""
    for b in buckets:
        if max_value <= b:
            return b
    return buckets[-1]
