"""Frozen counts of FastConformer XXL (``configs/fastconformer_xxl.json``): its
forward's FLOPs an utterance. The least time its relative-position attention
could take a call is ``relpos_counts.kernel_bounds``, whose count holds at any
head size.

``forward_flops(cfg, seconds)``: the model's products (2*M*N*K terms) for
one utterance of ``seconds`` at its own length: the log-mel front end; the
``dw_striding`` subsample by 8 (the first 3x3 convolution of one input
channel, then twice a depthwise 3x3 and a pointwise 1x1 of C channels, each
stage's time and mel bins L -> (L - 1) // 2 + 1) and the input projection;
then every block's feed-forwards (d -> 4d -> d, twice), q/k/v/out
projections, attention core (q.k, q.p and p.v: 6*T*T*d), pointwise and
depthwise convolutions; and the CTC head. The projection of the relative
positions (2T-1 rows of d x d a block) is made once a batch, not an
utterance, and is not counted.
"""

SR = 16000


def _half(n):
    return (n - 1) // 2 + 1


def forward_flops(cfg, seconds):
    """Analytic matmul FLOPs of one utterance's forward."""
    T = int(1 + seconds * SR / 160)           # mel frames
    F = cfg.n_mels
    C, d, k, L = cfg.subsample_channels, cfg.d_model, cfg.conv_kernel_size, cfg.n_blocks
    n_fft, n_bins = 400, 201
    fl = 2 * T * n_fft * 2 * n_bins + 2 * T * n_bins * F   # DFT and mel projection
    T, F = _half(T), _half(F)
    fl += 2 * T * F * 9 * C                   # the first convolution (one input channel)
    for _ in range(2):
        T, F = _half(T), _half(F)
        fl += 2 * T * F * 9 * C + 2 * T * F * C * C   # depthwise 3x3, pointwise 1x1
    fl += 2 * T * (F * C) * d                 # input projection
    f = cfg.ff_mult * d
    ff = 2 * T * d * f + 2 * T * f * d        # Linear(d, 4d), Linear(4d, d)
    attn = 4 * 2 * T * d * d + 3 * 2 * T * T * d   # q, k, v, out; q.k, q.p, p.v
    conv = 2 * T * d * 2 * d + 2 * T * k * d + 2 * T * d * d
    fl += L * (2 * ff + attn + conv)
    fl += 2 * T * d * cfg.n_classes           # CTC head
    return fl
