"""The plain reference of FastConformer XXL with a CTC head (NVIDIA's
Parakeet-CTC 1.1B; Rekesh et al. 2023, arXiv:2305.05084): model and
logits, in plain PyTorch, as served (no dropout, BatchNorm's running
statistics).

It imports nothing of the program and takes nothing the program made: the
weights come from ``asr_bench/fastconformer_weights.py``, the front end
and the rounding of products (``Precision``) from ``conformer_ctc.py``, the
blocks' modules from ``conformer_l.py`` (Conformer (L)'s block: pre-norm
half-step Swish FFNs, Transformer-XL's relative-position attention with
the rel-shift materialised, the LayerNorm conv module; here 42 blocks of d
1024, 8 heads of 128, an odd depthwise kernel of 9, padded 4 each side).

The subsample is NeMo's ``dw_striding`` by 8: Conv2d(1, C, 3x3, stride 2)
-> ReLU, then twice depthwise Conv2d(C, C, 3x3, stride 2, groups C) ->
pointwise Conv2d(C, C, 1x1) -> ReLU, every convolution padded 1; the (C,
F/8) planes flatten channel-major into Linear(C * F/8, d), whose output the
blocks take unscaled (the checkpoint's ``xscaling`` is false). Valid frames:
each stage's L -> (L - 1) // 2 + 1, three times, and each stage's frames
past its valid ones are zeroed before the next reads them, so a file's
logits are those of the file alone.

Where it departs from the published model, each the benchmark's own:
- the benchmark's log-mel front end (``conformer_ctc.features``) in place
  of NeMo's preprocessor;
- the seeded Turkish BPE of ``configs/fastconformer_xxl.json`` in place of
  the English 1024-piece SentencePiece; the CTC head is as published, a
  linear layer to the vocabulary and the blank (1025 outputs).

Files longer than 32 s run whole at buckets of 32 s steps (64, 96, ...,
256 s for the cell's ``full_context_s`` of 256), a copy of the program's
long-form rule; ``rows`` rows of one bucket at a time.

Precision as ``conformer_ctc.py``: ``"fp32"`` every product in float32
with TF32 off; ``"fp8"`` the control, each product's operands rounded to
float8 e4m3.
"""

import torch
import torch.nn.functional as F

from asr_bench.reference import conformer_l
from asr_bench.reference.conformer_ctc import SR, bucket, features, no_tf32

LONG_STEP = 32 * SR


def long_bucket(n, full_context_s=256):
    """The bucket a file of ``n`` samples runs whole in: the 32 s buckets up
    to 32 s, then 32 s steps up to ``full_context_s``."""
    if n <= LONG_STEP:
        return bucket(n)
    return min(-(-n // LONG_STEP), -(-int(full_context_s * SR) // LONG_STEP)) * LONG_STEP


def frames(lengths):
    """Valid frames after the subsample of input frame counts."""
    for _ in range(3):
        lengths = (lengths - 1) // 2 + 1
    return lengths


def _zero_past(h, lengths):
    valid = torch.arange(h.shape[2], device=h.device)[None, :] < lengths[:, None]
    return h * valid[:, None, :, None].float()


class Reference(conformer_l.Reference):
    """The model's function over a state dict ``sd`` (the program's names)
    and ``cfg`` (a dict of the configuration file)."""

    def forward(self, feats, frame_lengths):
        """(B, T, n_mels) features and (B,) frame counts -> (B, T', V)
        float32 logits."""
        lengths = frame_lengths.to(torch.int64)
        counts = frames(lengths)
        h = F.relu(self.p.conv2d(feats.float()[:, None], self.w("subsample.0.weight"),
                                 self.w("subsample.0.bias"), stride=2, padding=1))
        for i in (2, 5):
            lengths = (lengths - 1) // 2 + 1
            h = _zero_past(h, lengths)
            h = self.p.conv2d(h, self.w(f"subsample.{i}.weight"), self.w(f"subsample.{i}.bias"),
                              stride=2, padding=1, groups=h.shape[1])
            h = F.relu(self.p.conv2d(h, self.w(f"subsample.{i + 1}.weight"),
                                     self.w(f"subsample.{i + 1}.bias")))
        B, C, Th, Fh = h.shape
        h = self.lin("input_proj", h.permute(0, 2, 1, 3).reshape(B, Th, C * Fh))
        mask = torch.arange(Th, device=h.device)[None, :] < counts[:, None]
        for i in range(self.cfg["n_blocks"]):
            pre = f"blocks.{i}"
            h = h + 0.5 * self.ff(pre + ".ff1", self.ln(pre + ".norm_ff1", h))
            h = h + self.attn(pre + ".attn", self.ln(pre + ".norm_attn", h), mask)
            h = h + self.conv(pre + ".conv", h, mask)
            h = h + 0.5 * self.ff(pre + ".ff2", self.ln(pre + ".norm_ff2", h))
            h = self.ln(pre + ".final_norm", h)
        return self.lin("fc", h)


def logits_of(sd, cfg, waves, precision="fp32", device="cpu", rows=2, full_context_s=256):
    """Each row of samples, at the bucket its length falls in, -> a list of
    (valid frames, V) float32 logits. Up to ``rows`` rows of one bucket
    run together."""
    out = [None] * len(waves)
    by_bucket = {}
    for i, w in enumerate(waves):
        by_bucket.setdefault(long_bucket(len(w), full_context_s), []).append(i)
    ref = Reference(sd, cfg, precision)
    with torch.no_grad(), no_tf32():
        for S, idx in sorted(by_bucket.items()):
            for j in range(0, len(idx), rows):
                part = idx[j:j + rows]
                feats, lengths = features([waves[i] for i in part], S, cfg["n_mels"], device)
                logits = ref.forward(feats, lengths)
                for r, i in enumerate(part):
                    out[i] = logits[r, :int(frames(int(lengths[r])))].float().cpu()
    return out
