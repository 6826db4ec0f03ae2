# Copied from turkish_asr_tpu/utils/errors.py (the JAX package's utils
# __init__ imports JAX, so it cannot be imported from there).
"""Shared error types importable from package code."""


class TimestampsUnsupportedError(ValueError):
    """timestamps=True requested on a decoder without frame alignments
    (beam search). A dedicated type so servers can map it to 400 without
    reclassifying every internal ValueError as a client error."""
