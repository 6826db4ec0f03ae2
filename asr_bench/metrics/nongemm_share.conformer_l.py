"""Percent of kernel time in kernels that are neither GEMM or convolution nor the port's own
(profiler): ``readers.nongemm_share``'s rule, with the relative-position attention kernel among
the port's own."""

from asr_bench.readers import GEMM_OR_CONV, PORT_KERNELS

KERNELS = PORT_KERNELS + ("flash_relpos_fwd_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    total = other = 0.0
    for name, _, dur, _ in t.kernels():
        total += dur
        low = name.lower()
        if not any(p in low for p in GEMM_OR_CONV) and not any(p in name for p in KERNELS):
            other += dur
    return 100.0 * other / total if total > 0 else None
