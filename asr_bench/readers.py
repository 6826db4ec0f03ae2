"""What the per-layer metrics' readers share: shares of the device trace,
roofline shares of kernels under a harness span, and model FLOPs.

Shares are in percent. A reader returns None where its source holds
nothing to read (no trace, no span of its name), and the metric is then
left out of the line; it never returns 0 for a share of a roofline or of
a peak.
"""

from asr_bench import frozen

# Device kernels of GEMMs and convolutions, by the libraries' name parts
# (cuBLAS, cuBLASLt, cuDNN, CUTLASS and PyTorch's own convolutions).
GEMM_OR_CONV = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "cudnn", "convolve", "conv2d",
                "conv1d", "depthwise", "fprop", "dgrad", "wgrad")
# The port's hand-written kernels (turkish_asr_torch/csrc/*.cu).
PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_sum_chunks",
                "ctc_fwd_kernel", "ctc_bwd_kernel", "swiglu_fwd_kernel", "dump_keep_mask_kernel")


def idle_share(ctx):
    """Percent of the traced window with no device operation running."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def nongemm_share(ctx):
    """Percent of kernel time in kernels that are neither a GEMM or a
    convolution nor one of the port's own."""
    t = ctx.trace
    if t is None:
        return None
    total = other = 0.0
    for name, _, dur, _ in t.kernels():
        total += dur
        low = name.lower()
        if not any(p in low for p in GEMM_OR_CONV) and not any(p in name for p in PORT_KERNELS):
            other += dur
    return 100.0 * other / total if total > 0 else None


def roofline(ctx, spans):
    """Percent: the frozen bounds of every call under the harness spans
    ``spans`` ({span name: kernel_bounds name}) over the device time of
    everything those calls launched."""
    t = ctx.trace
    if t is None:
        return None
    bound_us = device_us = 0.0
    for span, kernel in spans.items():
        for attrs, events in t.under(ctx.spans, span):
            if not events:
                continue
            bound_us += 1e3 * frozen.kernel_bounds(kernel, **attrs)["bound_ms"]
            device_us += sum(e[2] for e in events)
    return 100.0 * bound_us / device_us if device_us > 0 else None


def mfu(ctx, passes):
    """Percent of the card's bf16 dense peak: ``passes`` x the frozen
    forward FLOPs of every utterance completed, each at its own length,
    over the window's seconds."""
    if ctx.peak_flops is None or not ctx.stats.get("utterance_samples"):
        return None
    flops = sum(frozen.model_forward_flops(ctx.cfg, n / frozen.SR)
                for n in ctx.stats["utterance_samples"])
    return 100.0 * passes * flops / (ctx.stats["window_s"] * ctx.peak_flops)
