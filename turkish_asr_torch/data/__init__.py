"""Tokenizers (copied from the JAX package) and the static waveform buckets."""
