"""The served forward under rounding-level changes of the attention's sums,
on chip_smoke.py's served model.

chip_smoke.py serves the flagship model with seeded random weights and
holds the kernel path's logits for an 8 s input within bf16's own noise
(max |plain bf16 - plain fp32|) of the plain path's. The kernel sums the
attention's rows in another order than the plain path. Here, on the CPU,
the plain path is held against itself with every attention row sum l scaled
by (1 + 1e-7 z), z standard normal: a change below two fp32 ulps, the size
by which two summation orders differ. The bf16 logits move by less than
that noise, and in fp32 no frame argmax moves.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.models import attention
from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.ops import _flash_attention as plain


@pytest.fixture(scope="module")
def served():
    """(logits(fn, dtype), plain bf16 logits, plain fp32 logits)."""
    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(chip_smoke._tone(8, 2))[None]
    feats, frames = log_mel_spectrogram(x, torch.tensor([x.shape[1]], dtype=torch.int32))

    def logits(fn, dtype):
        with mock.patch.object(attention, "flash_attention", fn), torch.inference_mode():
            return model(feats, frames, dtype).float().numpy()[0]

    return (logits, logits(plain.flash_attention_fwd_ref, torch.bfloat16),
            logits(plain.flash_attention_fwd_ref, torch.float32))


def _perturbed_l(seed):
    """The plain forward with each row sum l scaled by (1 + 1e-7 z)."""
    gen = torch.Generator().manual_seed(seed)

    def fn(q, k, v, mask=None, dropout_rate=0.0, seed=0):
        B, H, T, D = q.shape
        scores = plain._scores(q, k, mask)
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        l = e.sum(-1, keepdim=True)
        l = l * (1 + 1e-7 * torch.randn(l.shape, generator=gen))
        out = torch.matmul((e / l).to(v.dtype).float(), v.float())
        return out.reshape(B, H, T, D), None

    return fn


@pytest.mark.parametrize("seed", range(4))
def test_bf16_logits_stay_within_bf16_noise(served, seed):
    logits, ref, ref32 = served
    got = logits(_perturbed_l(seed), torch.bfloat16)
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.abs(got - ref).max() < np.abs(ref - ref32).max()


def test_fp32_argmaxes_do_not_move(served):
    logits, _, ref32 = served
    got32 = logits(_perturbed_l(0), torch.float32)
    assert (got32.argmax(-1) == ref32.argmax(-1)).all()
    assert np.abs(got32 - ref32).max() < 1e-4
