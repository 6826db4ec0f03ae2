"""Percent of kernel time in kernels that are neither GEMM or convolution nor the port's own
(profiler; the name classes are in asr_bench/readers.py)."""

from asr_bench.readers import nongemm_share


def read(ctx):
    return nongemm_share(ctx)
