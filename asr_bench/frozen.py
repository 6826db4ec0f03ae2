"""Frozen copies of the port's sound measuring arithmetic.

The benchmark keeps its own copies so that a later change to the program
cannot move the yardstick. Each function names the file and lines it was
copied from; the bodies are unchanged but for the names of the tables they
read.

- ``model_forward_flops``: turkish_asr_torch/bench.py:223-251 (itself a copy
  of bench.py:73-99), the analytic matmul FLOPs of one utterance's forward.
- ``PEAK_FLOPS_BY_CARD``: turkish_asr_torch/bench.py:134-138, the bf16
  dense peak of a card by its name (NVIDIA's data sheets).
- ``card``: turkish_asr_torch/bench.py:141-160 (``_card``), the card's name
  and power limit, matched by UUID.
- ``PEAK_FLOPS``, ``PEAK_BYTES``, ``kernel_bounds``: chip_smoke.py:289-290
  and :337-399, the least time a kernel's function could take.
"""

import functools
import subprocess

SR = 16000

PEAK_FLOPS_BY_CARD = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def model_forward_flops(cfg, seconds):
    """Analytic matmul FLOPs for one utterance forward (2*M*N*K terms).

    Copied from bench.py::model_forward_flops (:73-99), body unchanged."""
    T = int(1 + seconds * SR / 160)      # mel frames
    F, d, L = cfg.n_mels, cfg.d_model, cfg.n_blocks
    T2, T4 = T // 2, T // 4
    F2, F4 = F // 2, F // 4
    dh = d // cfg.n_heads
    fl = 0
    # mel front-end: frames (T, n_fft) x DFT (n_fft, 2*bins) + mel proj
    n_fft, n_bins = 400, 201
    fl += 2 * T * n_fft * 2 * n_bins + 2 * T * n_bins * F
    # subsample convs + input proj
    fl += 2 * T2 * F2 * 9 * cfg.d_model            # conv1 (C_in=1)
    fl += 2 * T4 * F4 * 9 * d * d                  # conv2
    fl += 2 * T4 * (F4 * d) * d                    # input projection
    # conformer blocks
    per_ff = 2 * (T4 * d * 8 * d) + 2 * (T4 * 4 * d * d)   # SwiGLU in+out
    attn = (2 * T4 * d * d                      # q proj
            + 2 * 2 * T4 * d * dh               # k/v proj (MQA single head)
            + 2 * 2 * T4 * T4 * d               # scores + context
            + 2 * T4 * d * d)                   # out proj
    conv = (2 * T4 * d * 2 * d                  # pw1
            + 2 * T4 * 31 * d                   # depthwise k=31
            + 2 * T4 * d * d)                   # pw2
    fl += L * (2 * per_ff + attn + conv)
    fl += 2 * T4 * d * cfg.n_classes            # classifier head
    return fl


@functools.lru_cache(maxsize=None)
def card(device):
    """(name, power limit in W) of a CUDA ``device``; (None, None) on the
    CPU. The power limit is nvidia-smi's for the card whose UUID is the
    device's (so CUDA_VISIBLE_DEVICES and other cards on the host do not
    mix in), read once; None where nvidia-smi does not list that card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(dev)
    uuid = f"GPU-{torch.cuda.get_device_properties(dev).uuid}"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        limits = dict(line.split(", ", 1) for line in smi.stdout.splitlines() if ", " in line)
        watts = float(limits[uuid].split()[0])
    except (OSError, subprocess.SubprocessError, KeyError, ValueError):
        watts = None
    return name, watts


def kernel_bounds(name, **shape):
    """The least time the card could take for one call of a kernel's
    function: the larger of its operations over the peak rate for their
    type and its bytes over the memory rate, each input read once and each
    output written once. Returns {"flops", "bytes", "bound_ms", "bound_by"}.

    flash_attention_fwd / _bwd (B, H, Kh, T, D, dtype="bf16"): q (B, H, T, D)
      and k, v (B, Kh, T, D) in dtype, mask (B, T) uint8; the forward writes
      out (B, H, T, D) and lse, m, l (B, H, T) fp32 and does 4*B*H*T*T*D
      flops (q k^T and p v); the backward reads g (B, H, T, D) and m, l,
      delta (B, H, T) fp32, writes dq, dk, dv fp32 and does 10*B*H*T*T*D
      flops (q k^T, g v^T, y^T g, ds^T q, ds k). bf16 inputs run on the
      tensor cores (989 TFLOP/s); fp32 inputs are held to the fp32 rate.
    dropout_mask (B, H, T): writes the (B, H, T, T) one-byte keep mask; the
      hash is integer work the peak table has no rate for, so the bound is
      bytes only.
    ctc_fwd / ctc_bwd (B, T, V, L), S = 2L + 1 lanes: the forward reads
      log-probs (B, T, V) fp32, targets (B, L) int32 and the two (B,) int32
      lengths (the kernels build the extended labels and skip flags from
      the targets), writes alpha (B, T, S) and nll (B,) fp32; the backward
      also reads alpha, nll and the (B,) cotangent and writes the
      (B, T, V) fp32 gradient (it builds its label chains itself). About
      10 fp32 operations per lane and frame in the forward (a three-way
      logaddexp) and 20 in the backward (beta and the gradient), at the
      fp32 rate.
    swiglu_fwd (M, C, F): x (M, C), w1 (C, 2F), w2 (F, C) bf16, b1 (2F,),
      b2 (C,) fp32, y (M, C) bf16; 6*M*C*F flops on the tensor cores.
    """
    if name in ("flash_attention_fwd", "flash_attention_bwd"):
        B, H, Kh, T, D = (shape[k] for k in ("B", "H", "Kh", "T", "D"))
        dtype = shape.get("dtype", "bf16")
        qkv = (B * H * T * D + 2 * B * Kh * T * D) * (2 if dtype == "bf16" else 4) + B * T
        if name == "flash_attention_fwd":
            flops, nbytes = 4 * B * H * T * T * D, qkv + 4 * (B * H * T * D + 3 * B * H * T)
        else:
            flops = 10 * B * H * T * T * D
            nbytes = qkv + 4 * (2 * B * H * T * D + 3 * B * H * T + 2 * B * Kh * T * D)
        peak = PEAK_FLOPS[dtype]
    elif name == "dropout_mask":
        B, H, T = shape["B"], shape["H"], shape["T"]
        flops, nbytes, peak = 0, B * H * T * T, PEAK_FLOPS["fp32"]
    elif name in ("ctc_fwd", "ctc_bwd"):
        B, T, V, L = shape["B"], shape["T"], shape["V"], shape["L"]
        S = 2 * L + 1
        inputs = 4 * B * T * V + 4 * B * L + 8 * B
        if name == "ctc_fwd":
            flops, nbytes = 10 * B * T * S, inputs + 4 * B * T * S + 4 * B
        else:
            flops = 20 * B * T * S
            nbytes = inputs + 4 * B * T * S + 8 * B + 4 * B * T * V
        peak = PEAK_FLOPS["fp32"]
    elif name == "swiglu_fwd":
        M, C, F = shape["M"], shape["C"], shape["F"]
        flops = 6 * M * C * F
        nbytes = 2 * (M * C + C * 2 * F + F * C + M * C) + 4 * (2 * F + C)
        peak = PEAK_FLOPS["bf16"]
    else:
        raise ValueError(f"no bound for kernel {name!r}")
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    bound = {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    return bound
