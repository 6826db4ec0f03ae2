"""Memorization on the CPU (slow), the port's counterpart of
tests/test_overfit.py: five words, d_model 64, 2 heads, 2 blocks, AdamW at
3e-3, 300 steps (``turkish_asr_torch/scripts/overfit.py``; chip_smoke.py
runs the same on the card, through the kernels). The loss must end below
0.1 and the greedy texts must be the words."""

import pytest
import torch

from turkish_asr_torch.scripts.overfit import WORDS, memorize


@pytest.mark.slow
def test_overfit_five_utterances():
    result = memorize("cpu", torch.float32)
    assert result["final_loss"] < 0.1, result
    assert result["texts"] == list(WORDS)
