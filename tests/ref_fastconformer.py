"""Plain reference of FastConformer XXL with a CTC head (NVIDIA's Parakeet-CTC
1.1B; Rekesh et al. 2023, arXiv:2305.05084), for the tests: the forward in
plain ``torch``, float32 with TF32 off, over a state dict with the port's
names. It imports nothing of the port and nothing of JAX.

- The subsample is NeMo's ``dw_striding`` by 8: Conv2d(1, C, 3x3, stride 2)
  -> ReLU, then twice depthwise Conv2d(C, C, 3x3, stride 2, groups C) ->
  pointwise Conv2d(C, C, 1x1) -> ReLU, every convolution padded 1; the
  (C, F/8) planes flatten channel-major into Linear(C * F/8, d), whose output
  the blocks take unscaled (the checkpoint's ``xscaling`` is false).
- Valid frames: each stage's L -> (L - 1) // 2 + 1, three times; a stage's
  frames past its valid ones are zeroed before the next reads them, so a
  file's logits are those of the file alone.
- The blocks are Conformer (L)'s (``ref_conformer_l.blocks``: pre-norm
  macaron FFNs with Swish, Transformer-XL relative-position attention with
  the rel-shift materialised, the LayerNorm conv module), here with an odd
  depthwise kernel (9: 4 frames each side).

Departures from the published model, each the benchmark's own:
- the port's log-mel front end (the tests hand both sides the same
  features) in place of NeMo's preprocessor;
- the seeded Turkish BPE of the benchmark in place of the English
  1024-piece SentencePiece: the CTC head is as published, a linear layer to
  the vocabulary and the blank (1025 outputs), over another vocabulary.
"""

import torch
import torch.nn.functional as F

from ref_conformer_l import blocks


def frames(lengths):
    """Valid frames after the subsample of (B,) input frame counts."""
    for _ in range(3):
        lengths = (lengths - 1) // 2 + 1
    return lengths


def _zero_past(h, lengths):
    """(B, C, T, F) with the frames at or past each row's length zeroed."""
    valid = torch.arange(h.shape[2])[None, :] < lengths[:, None]
    return h * valid[:, None, :, None].float()


def forward(sd, cfg, feats, frame_lengths):
    """(B, T, n_mels) features, (B,) frame counts -> (B, T', V) float32
    logits. ``cfg``: n_heads, n_blocks, conv_kernel_size."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        w = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
        return _forward(w, cfg, feats.float(), frame_lengths)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _forward(w, cfg, feats, frame_lengths):
    lengths = frame_lengths.to(torch.int64)
    h = F.relu(F.conv2d(feats[:, None], w["subsample.0.weight"], w["subsample.0.bias"],
                        stride=2, padding=1))
    for i in (2, 5):
        lengths = (lengths - 1) // 2 + 1
        h = _zero_past(h, lengths)
        C = h.shape[1]
        h = F.conv2d(h, w[f"subsample.{i}.weight"], w[f"subsample.{i}.bias"], stride=2,
                     padding=1, groups=C)
        h = F.relu(F.conv2d(h, w[f"subsample.{i + 1}.weight"], w[f"subsample.{i + 1}.bias"]))
    B, C, T, Fh = h.shape
    h = h.permute(0, 2, 1, 3).reshape(B, T, C * Fh) @ w["input_proj.weight"].t()
    h = h + w["input_proj.bias"]
    mask = torch.arange(T)[None, :] < frames(frame_lengths.to(torch.int64))[:, None]
    h = blocks(w, cfg, h, mask)
    return h @ w["fc.weight"].t() + w["fc.bias"]
