"""``--remat_policy dots``, ``--profile_dir`` and the torch-built RoPE
tables, on the CPU.

- ``dots`` (torch.utils.checkpoint with ``dots_saveable``) gives the
  gradients and BatchNorm statistics of ``full`` and of no recomputation,
  with dropout on (fp32, 1e-6; the dropout masks come from explicit seeds,
  so every recompute is exact).
- What ``dots`` saves in each block is what JAX's
  ``dots_with_no_batch_dims_saveable`` saves: the eight linear products
  (the two SwiGLU FFNs' two each, q, k, v, out), and not the pointwise
  convolutions' products, which JAX computes as convolutions. The policy's
  decisions are recorded and counted by output width.
- ``--profile_dir`` writes a Chrome trace of the start epoch's first
  ``PROFILE_BATCHES`` batches (or of the whole epoch when it is shorter),
  naming the attention op, and none in later epochs.
- ``attention.rope_tables`` (torch, fp64, used for a symbolic length under
  ``torch.export``) is within one fp32 ulp of the numpy tables the eager
  cache holds.
"""

import json
import os

import numpy as np
import pytest
import torch

from turkish_asr_torch.data.tokenizer import CharTokenizer
from turkish_asr_torch.models import attention, conformer
from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.train import trainer as trainer_mod
from turkish_asr_torch.train.optim import make_optimizer
from turkish_asr_torch.train.trainer import Trainer
from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.logger import get_logger

CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56)


def _grads(model, remat):
    feats = torch.randn(2, 61, 80, generator=torch.Generator().manual_seed(0))
    logits, bn = model(feats, torch.tensor([61, 33]), torch.float32, train=True, seed=99,
                       remat=remat)
    logits.square().mean().backward()
    grads = [p.grad.clone() for p in model.parameters() if p.requires_grad]
    model.zero_grad()
    return grads, bn


def test_dots_gradients_equal_full_and_none():
    model = init_model(ModelConfig(**CFG, dropout=0.3), torch.Generator().manual_seed(0))
    want, want_bn = _grads(model, False)
    for remat in ("full", "dots"):
        got, bn = _grads(model, remat)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        for (m, v), (wm, wv) in zip(bn, want_bn):
            torch.testing.assert_close(m, wm, rtol=0, atol=1e-6)
            torch.testing.assert_close(v, wv, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        _grads(model, "everything")


def test_dots_saves_the_linear_products_only(monkeypatch):
    saved = []
    policy = conformer.dots_saveable

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and \
                not ctx.is_recompute:
            saved.append((op, tuple(args[0].shape), tuple(args[1].shape)))
        return decision

    monkeypatch.setattr(conformer, "dots_saveable", recording)
    model = init_model(ModelConfig(**CFG, dropout=0.1), torch.Generator().manual_seed(0))
    _grads(model, "dots")
    d, d_head, d_ff = 64, 16, 4 * 64
    per_block = sorted([2 * d_ff, d, 2 * d_ff, d, d, d_head, d_head, d])  # ff1, q k v out, ff2
    assert all(op is torch.ops.aten.mm.default for op, _, _ in saved)
    widths = sorted(w[1] for _, _, w in saved)
    assert len(saved) == 8 * CFG["n_blocks"]
    assert widths == sorted(per_block * CFG["n_blocks"])
    # The pointwise convolutions (d -> 2d, d -> d) are matmuls in the port;
    # their products are recomputed: no product of width 2d is saved.
    assert 2 * d not in widths
    saved.clear()
    _grads(model, "full")
    assert not saved


def _batch(seed, B=2, S=8000):
    rng = np.random.default_rng(seed)
    return {"waveforms": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
            "wav_lengths": np.asarray([S, S - 1500], np.int32),
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3], np.int32),
            "sample_mask": np.ones((B,), np.float32)}


def _events(path, name):
    with open(path) as f:
        trace = json.load(f)
    return sum(1 for e in trace["traceEvents"] if e.get("name") == name)


@pytest.mark.parametrize("window", [2, 20])
def test_profile_dir_traces_the_start_epochs_first_batches(tmp_path, monkeypatch, window):
    """Three batches an epoch, one block, no recompute: the attention op
    runs once a step. A window of 2 traces two steps; a window of 20 is cut
    by the epoch's end. The second epoch is not traced."""
    monkeypatch.setattr(trainer_mod, "PROFILE_BATCHES", window)
    cfg = ModelConfig(**{**CFG, "n_blocks": 1, "d_model": 32, "n_heads": 2}, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    config = get_config(["--profile_dir", str(tmp_path / "trace"), "--no_remat",
                         "--checkpoint_dir", str(tmp_path), "--log_interval", "100"])
    opt, sched = make_optimizer([p for p in model.parameters() if p.requires_grad], 1e-3,
                                1e-6, total_steps=10)
    tr = Trainer(model, opt, sched, config, get_logger(f"remat_profile{window}",
                                                       str(tmp_path / "t.log")),
                 tokenizer=CharTokenizer(), device="cpu", compute_dtype=torch.float32)
    tr.train_loader = [_batch(i) for i in range(3)]
    tr.train_epoch(1)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and tr.profile_trace == str(tmp_path / "trace" / files[0])
    assert _events(tr.profile_trace, "turkish_asr_torch::flash_attention_fwd") == min(window, 3)
    tr.train_epoch(2)
    assert len(os.listdir(tmp_path / "trace")) == 1


@pytest.mark.parametrize("T,dim", [(1, 16), (37, 16), (200, 64), (601, 64), (1501, 128)])
def test_rope_tables_from_torch_match_numpy(T, dim):
    want_cos, want_sin = attention._rope_tables_np(T, dim, 10000.0)
    cos, sin = attention.rope_tables(T, dim, torch.float32, torch.device("cpu"))
    np.testing.assert_array_max_ulp(cos.numpy(), want_cos, maxulp=1)
    np.testing.assert_array_max_ulp(sin.numpy(), want_sin, maxulp=1)
