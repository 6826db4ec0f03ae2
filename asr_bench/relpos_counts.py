"""Frozen counts of Conformer (L) (``configs/conformer_l.json``): its
forward's FLOPs an utterance, and the least time its relative-position
attention could take a call, counted the same whatever implements it.

- ``forward_flops(cfg, seconds)``: the model's products (2*M*N*K terms) for
  one utterance of ``seconds`` at its own length: the log-mel front end,
  the two stride-2 3x3 subsample convolutions and the input projection,
  then every block's feed-forwards (d -> 4d -> d, twice), q/k/v/out
  projections, attention core (q.k, q.p and p.v: 6*T*T*d), pointwise and
  depthwise convolutions, and the CTC head. The projection of the
  relative positions (2T-1 rows of d x d a block) is made once a batch,
  not an utterance, and is not counted.
- ``kernel_bounds(B, H, T, D, dtype)``: 6*B*H*T*T*D flops (one q.k, one
  q.p_{i-j} and one p.v product for each (i, j) pair) at the type's peak,
  against the bytes of q, k, v and the output at their dtype, p at
  H*(2T-1)*D of the dtype, and u and v (H*D fp32 each), at the card's
  memory rate: the larger of the two times.
"""

from asr_bench import frozen

SR = 16000


def forward_flops(cfg, seconds):
    """Analytic matmul FLOPs of one utterance's forward."""
    T = int(1 + seconds * SR / 160)           # mel frames
    T2 = (T - 1) // 2 + 1                     # after each stride-2 conv (padding 1)
    T4 = (T2 - 1) // 2 + 1
    F = cfg.n_mels
    F2 = (F - 1) // 2 + 1
    F4 = (F2 - 1) // 2 + 1
    d, k, L = cfg.d_model, cfg.conv_kernel_size, cfg.n_blocks
    n_fft, n_bins = 400, 201
    fl = 2 * T * n_fft * 2 * n_bins + 2 * T * n_bins * F   # DFT and mel projection
    fl += 2 * T2 * F2 * 9 * d                 # conv1 (one input channel)
    fl += 2 * T4 * F4 * 9 * d * d             # conv2
    fl += 2 * T4 * (F4 * d) * d               # input projection
    f = cfg.ff_mult * d
    ff = 2 * T4 * d * f + 2 * T4 * f * d      # Linear(d, 4d), Linear(4d, d)
    attn = 4 * 2 * T4 * d * d + 3 * 2 * T4 * T4 * d   # q, k, v, out; q.k, q.p, p.v
    conv = 2 * T4 * d * 2 * d + 2 * T4 * k * d + 2 * T4 * d * d
    fl += L * (2 * ff + attn + conv)
    fl += 2 * T4 * d * cfg.n_classes          # CTC head
    return fl


def kernel_bounds(B, H, T, D, dtype="bf16"):
    """{"flops", "bytes", "bound_ms", "bound_by"} of one call of the
    relative-position attention at these shapes."""
    size = 2 if dtype == "bf16" else 4
    flops = 6 * B * H * T * T * D
    nbytes = 4 * B * T * H * D * size + H * (2 * T - 1) * D * size + 2 * H * D * 4
    t_ops, t_bytes = flops / frozen.PEAK_FLOPS[dtype], nbytes / frozen.PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}
