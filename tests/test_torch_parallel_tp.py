"""Tensor and sequence parallelism (``model`` and ``seq`` meshes) against
the one-process run, on gloo ranks (tests/torch_parallel_worker.py).

- ``model=2``: the loss within 1e-4 relative (JAX
  tests/test_parallel.py::test_tensor_parallel_forward_matches) and the
  gradients of the full (gathered) parameters within rtol 1e-3 / atol 1e-4;
  the gathered state dict equals the unsharded one bit for bit.
- ``seq=2`` with an odd T' (13 frames: 7 and 6 a rank): the loss and
  gradients within JAX tests/test_sequence_parallel.py's rtol 1e-3 / atol
  1e-4.
- ``data=2,model=2`` on four ranks: one step, the loss within 1e-4 and the
  weights after it within 1e-4 of the one-process run's.
- dropout (rate 0.3): the model and seq ranks' logits equal each other bit
  for bit and the one-process model's (same seed) within 1e-5; the two
  data ranks, given the same rows, draw other masks; the attention kernel
  seed of data rank r is (seed + r * 0x6A09E667) mod 2^32, so the two
  ranks' attention keep masks differ.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from turkish_asr_torch.models.conformer import ModelConfig, init_model  # noqa: E402
from turkish_asr_torch.ops.flash_attention import dump_keep_mask  # noqa: E402
from turkish_asr_torch.parallel.mesh import shard_seed  # noqa: E402
import torch_parallel_worker as W  # noqa: E402

CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56)


def _batch(seed, B=2, S=8000):
    """S = 8000 samples: 51 log-mel frames, T' = 13 after subsampling."""
    rng = np.random.default_rng(seed)
    return {"waveforms": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
            "wav_lengths": np.asarray([S, S - 2600], np.int32)[:B],
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3], np.int32)[:B],
            "sample_mask": np.ones((B,), np.float32)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfg = {**CFG, "dropout": 0.0}
    torch.save(init_model(ModelConfig(**cfg), torch.Generator().manual_seed(0)).state_dict(),
               tmp / "init.pt")
    torch.save([[_batch(1)]], tmp / "one.pt")
    one = W.train(str(tmp), cfg, str(tmp / "init.pt"), str(tmp / "one.pt"), grads=True)
    return tmp, cfg, one


@pytest.mark.parametrize("spec", ["model=2", "seq=2"])
def test_model_and_seq_parallel_match_one_process(setup, spec):
    tmp, cfg, one = setup
    ranks = W.run_ranks(tmp, "train", 2, cfg=cfg, init=str(tmp / "init.pt"),
                        batches=str(tmp / "one.pt"), mesh_spec=spec, grads=True)
    init = torch.load(tmp / "init.pt", weights_only=True)
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], one["loss0"], rtol=1e-4)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        for k, g in one["grads0"].items():
            torch.testing.assert_close(r["grads0"][k], g, rtol=1e-3, atol=1e-4)
        for k, v in init.items():  # the gathered state dict of the sharded model
            assert torch.equal(r["state_init"][k], v), k
        assert r["state_init"].keys() == init.keys()
    if spec == "model=2":  # the ranks hold halves of the sharded weights
        q = "blocks.0.attn.linear_q.weight"
        assert ranks[0]["local_state"][q].shape[0] == init[q].shape[0] // 2


def test_data_and_model_parallel_on_four_ranks(setup, tmp_path):
    tmp, cfg, _ = setup
    batch = _batch(2, B=4)
    batch["wav_lengths"] = np.asarray([8000, 5400, 7000, 6000], np.int32)
    batch["target_lengths"] = np.asarray([4, 3, 2, 4], np.int32)
    torch.save([[batch]], tmp_path / "one.pt")
    torch.save([[{k: v[d::2] for k, v in batch.items()} for d in range(2)]], tmp_path / "two.pt")
    one = W.train(str(tmp_path), cfg, str(tmp / "init.pt"), str(tmp_path / "one.pt"))
    ranks = W.run_ranks(tmp_path, "train", 4, cfg=cfg, init=str(tmp / "init.pt"),
                        batches=str(tmp_path / "two.pt"), mesh_spec="data=2,model=2")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        for k, v in one["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=1e-4)


def test_dropout_masks_across_ranks(tmp_path):
    """Replicated activations get one mask on every model and seq rank, the
    one-process model's; data ranks draw their own."""
    cfg = {**CFG, "dropout": 0.3}
    torch.save(init_model(ModelConfig(**cfg), torch.Generator().manual_seed(0)).state_dict(),
               tmp_path / "init.pt")
    g = torch.Generator().manual_seed(1)
    torch.save({"x": torch.randn(2, 57, 80, generator=g), "lengths": torch.tensor([57, 40])},
               tmp_path / "f.pt")  # T' = 15
    args = dict(cfg=cfg, init=str(tmp_path / "init.pt"), feats=str(tmp_path / "f.pt"), seed=7)
    one = W.forward(str(tmp_path), **args)
    assert not torch.equal(one["logits"], W.forward(str(tmp_path), **{**args, "seed": 8})["logits"])
    for spec in ("model=2", "seq=2"):
        a, b = (r["logits"] for r in W.run_ranks(tmp_path, "forward", 2, mesh_spec=spec, **args))
        assert torch.equal(a, b), spec
        torch.testing.assert_close(a, one["logits"], rtol=0, atol=1e-5)
    a, b = (r["logits"] for r in W.run_ranks(tmp_path, "forward", 2, mesh_spec="data=2",
                                             data_rows=False, **args))
    assert (a - b).abs().max() > 0.1
    seeds = [shard_seed(1234, r, bits=32) for r in range(2)]
    assert seeds == [1234, 1234 + 0x6A09E667]
    masks = [dump_keep_mask(2, 4, 15, s, 0.3, "cpu") for s in seeds]
    assert not torch.equal(masks[0], masks[1])
