"""The port's parallel layer (turkish_asr_torch/parallel/) against the JAX
package's and against the one-process run: the mesh, the sampler's process
slices, and data-parallel training on two gloo ranks.

- ``make_mesh`` parses specs as JAX ``make_mesh`` does (names, sizes, the
  inferred ``-1``, the error) and lays ranks out as JAX lays devices out;
- ``BucketingSampler``'s process slices equal the JAX sampler's;
- ``data=2`` follows the JAX ``Trainer`` on the one-process global batch
  for 3 steps at accumulation 1 and 2, through ``state_dict_from_jax``:
  losses within 1e-5 relative, weights within the train-parity tolerance
  of tests/test_torch_train.py (1e-5 absolute; the depthwise conv bias,
  whose gradient is rounding noise, within 3 lr, and so the few elements
  whose Adam gradient scale is under ten times Adam's eps, ``_noise``);
- a ragged global batch (2 and 1 valid samples, waveforms padded to other
  lengths on the two ranks) gives the one-process loss and gradients, which
  local BatchNorm statistics or a mean of the ranks' means would not, and
  the one-process weights after the step (the same tolerance);
- a NaN in one rank's waveform makes every rank skip the step.

Each multi-process run starts its ranks with tests/torch_parallel_worker.py
(gloo over a FileStore, one thread a rank, killed at its timeout).
"""

import math
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig  # noqa: E402
from turkish_asr_tpu.models.conformer import init_model as jax_init  # noqa: E402
from turkish_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from turkish_asr_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from turkish_asr_torch.parallel.mesh import make_mesh  # noqa: E402
from turkish_asr_torch.utils.weights import (  # noqa: E402
    jax_params_from_state_dict, jax_trees_from_state_dict, state_dict_from_jax)
import torch_parallel_worker as W  # noqa: E402

CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=1, n_classes=56)
LR = 1e-3


def _batch(seed, B=4, S=8000):
    rng = np.random.default_rng(seed)
    return {"waveforms": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
            "wav_lengths": np.asarray([S, S - 1500, S - 3000, S - 700], np.int32)[:B],
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3, 2, 4], np.int32)[:B],
            "sample_mask": np.ones((B,), np.float32)}


def _slices(batch, n=2):
    """Data rank d's rows: the interleaved slice the sampler gives it."""
    return [{k: v[d::n] for k, v in batch.items()} for d in range(n)]


@pytest.mark.parametrize("spec", ["data=2,model=4", "data=-1,model=2", "model=2,seq=-1",
                                  "seq=8", "data=3,model=5", "data=2,seq=2,model=2"])
def test_mesh_spec_parsing_matches_jax(spec):
    """Names, sizes, the inferred -1 and the error of JAX ``make_mesh`` on
    its 8 CPU devices; ranks laid out as JAX lays out devices."""
    devices = jax.devices()[:8]
    try:
        want = jax_make_mesh(spec, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            make_mesh(spec, 8)
        return
    got = make_mesh(spec, 8)
    assert got.names == want.axis_names
    assert got.sizes == want.devices.shape
    ids = np.vectorize(lambda d: devices.index(d))(want.devices)
    np.testing.assert_array_equal(got.ranks, ids)
    for rank in range(8):  # each rank's lines are the JAX mesh's lines through its device
        mesh = make_mesh(spec, 8, rank=rank)
        pos = np.argwhere(ids == rank)[0]
        for axis, name in enumerate(got.names):
            index = list(pos)
            index[axis] = slice(None)
            assert mesh.group(name).ranks == tuple(ids[tuple(index)])
            assert mesh.index(name) == pos[axis]


def test_global_batch_must_split_over_the_data_ranks():
    from turkish_asr_torch.parallel.mesh import check_batch
    mesh = make_mesh("data=2,model=2", 4)
    check_batch(mesh, 8)
    check_batch(None, 7)
    with pytest.raises(ValueError, match="global batch axis 7 not divisible by the 2 ranks"):
        check_batch(mesh, 7)
    with pytest.raises(ValueError, match="not divisible by the 4 ranks"):
        check_batch(make_mesh("data=4", 4), 6)


@pytest.mark.parametrize("process_count", [2, 4, 8])
def test_sampler_process_slices_match_jax(process_count):
    """The port's BucketingSampler hands each process the JAX sampler's
    slice of every batch (tests/test_multihost.py::test_sampler_process_slicing),
    at 2, 4 and 8 processes."""
    from turkish_asr_tpu.data.dataset import BucketingSampler as JaxSampler
    from turkish_asr_torch.data.dataset import BucketingSampler

    class FakeDS:
        file_pairs = [(f"/nonexistent/{i}.wav", "") for i in range(10)]

        def __len__(self):
            return 10

    pc = process_count
    batch = max(4, pc)  # 10 items: 2 full batches of 4, or 1 of 8
    for shuffle in (False, True):
        slices = []
        for p in range(pc):
            got = list(BucketingSampler(FakeDS(), batch, shuffle=shuffle, seed=3,
                                        process_index=p, process_count=pc))
            want = list(JaxSampler(FakeDS(), batch, shuffle=shuffle, seed=3,
                                   process_index=p, process_count=pc))
            assert got == want and len(got) == 10 // batch
            assert all(len(b) == batch // pc for b in got)
            slices.append(got)
        for step in zip(*slices):  # the processes' slices of a batch are disjoint
            assert len(set().union(*step)) == batch
    with pytest.raises(ValueError):
        BucketingSampler(FakeDS(), 5, process_index=0, process_count=pc)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("accum", [1, 2])
def test_data_parallel_follows_jax_trainer(tmp_path, accum):
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer
    from turkish_asr_tpu.parallel.mesh import shard_batch
    from turkish_asr_tpu.train.trainer import Trainer as JaxTrainer
    from turkish_asr_tpu.utils.config import get_config as jax_get_config
    from turkish_asr_tpu.utils.logger import get_logger as jax_get_logger

    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG, dropout=0.0))
    torch.save(state_dict_from_jax(_np(params), _np(state), CFG["n_heads"]), tmp_path / "init.pt")
    batches = [_batch(i) for i in range(3)]
    torch.save([_slices(b) for b in batches], tmp_path / "batches.pt")
    ranks = W.run_ranks(tmp_path, "train", 2, cfg={**CFG, "dropout": 0.0},
                        init=str(tmp_path / "init.pt"), batches=str(tmp_path / "batches.pt"),
                        mesh_spec="data=2", accum=accum)

    tx, sched = jax_make_optimizer(LR, 1e-6, total_steps=100, accumulation_steps=accum)
    jtr = JaxTrainer(model_cfg=JaxConfig(**CFG, dropout=0.0), params=params, model_state=state,
                     optimizer=tx, schedule=sched,
                     config=jax_get_config(["--accumulation_steps", str(accum)]),
                     logger=jax_get_logger("test_torch_parallel.jax", str(tmp_path / "j.log")),
                     tokenizer=TurkishTokenizer(),
                     mesh=jax_make_mesh(None, devices=jax.devices()[:1]),
                     accumulation_steps=accum, compute_dtype=jnp.float32)
    jlosses = []
    for i, batch in enumerate(batches):
        jtr.params, jtr.model_state, jtr.opt_state, jloss = jtr._train_step(
            jtr.params, jtr.model_state, jtr.opt_state, shard_batch(jtr.mesh, batch),
            jax.random.PRNGKey(i))
        jlosses.append(float(jloss))
    jtr.sync_global_step()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        assert r["global_step"] == jtr.global_step == 3 // accum
    for k, v in ranks[1]["local_state"].items():
        assert torch.equal(v, ranks[0]["local_state"][k]), k  # the replicas agree bit for bit
    got_params, got_state = jax_trees_from_state_dict(ranks[0]["state"])
    _assert_params_close(got_params, _np(jtr.params), got_state, _np(jtr.model_state),
                         _noise(ranks[0], 3 // accum))


def _noise(run, count):
    """Per element: True where Adam's gradient scale sqrt(nu / (1 -
    b2^count)) is under 1e-7, ten times its eps. There the update is
    lr * g / (|g| + eps) with g made of rounding noise, so its size
    follows the rounding of g: such an element is held as the depthwise
    conv bias is, within 3 lr."""
    scale = [torch.sqrt(n / (1 - 0.999 ** count)) < 1e-7 for n in run["nu"]]
    return jax_params_from_state_dict({k: v.float() for k, v in zip(run["names"], scale)})


def _assert_params_close(got, want, got_state, want_state, noise, atol=1e-5):
    """tests/test_torch_train.py's train-parity tolerance: ``atol``, 1e-5
    absolute (1% of the learning rate); the depthwise conv bias, whose gradient is
    rounding noise (BatchNorm removes a per-channel shift exactly), and the
    elements ``noise`` marks, within 3 lr; the BatchNorm running mean,
    which follows that bias, within the bias's difference."""
    bias_diff = np.abs(got["blocks"]["conv"]["dw"]["b"] - want["blocks"]["conv"]["dw"]["b"]).max()
    assert bias_diff <= 3 * LR
    marked = sum(int(n.sum()) for n in jax.tree.leaves(noise))
    assert marked < 0.01 * sum(n.size for n in jax.tree.leaves(noise))  # rare
    noise["blocks"]["conv"]["dw"]["b"][:] = 1.0
    leaves = zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(noise))
    for a, b, n in leaves:
        n = n.astype(bool)
        np.testing.assert_allclose(a[~n], b[~n], rtol=0, atol=atol)
        np.testing.assert_allclose(a[n], b[n], rtol=0, atol=3 * LR)
    got_bn, want_bn = got_state["blocks"]["bn"], want_state["blocks"]["bn"]
    np.testing.assert_allclose(got_bn["mean"], want_bn["mean"], rtol=0, atol=bias_diff + 1e-6)
    np.testing.assert_allclose(got_bn["var"], want_bn["var"], rtol=1e-5, atol=1e-6)


def _ragged_batch():
    """Global batch of 4: rank 0 gets rows 0 and 2 (two valid samples),
    rank 1 rows 1 and 3 (one valid, one padding row), each padded to its
    own longest waveform, as the loader pads each rank's slice."""
    batch = _batch(7)
    batch["wav_lengths"] = np.asarray([8000, 5000, 6400, 3000], np.int32)
    batch["sample_mask"] = np.asarray([1, 1, 1, 0], np.float32)
    batch["waveforms"] *= 0.5 + np.arange(4, dtype=np.float32)[:, None]  # unlike rows
    for i, n in enumerate(batch["wav_lengths"]):
        batch["waveforms"][i, n:] = 0.0
    parts = _slices(batch)
    parts[1]["waveforms"] = parts[1]["waveforms"][:, :5000]
    return batch, parts


def test_ragged_batch_and_nan_skip_match_one_process(tmp_path):
    """data=2 on a ragged global batch: the loss is the global batch's
    mean (not a mean of the ranks' means: 2 and 1 valid samples), the
    BatchNorm statistics the global batch's, the padding the global
    batch's; the first step's loss and gradients and the weights after it
    equal the one-process run's. Then rank 1's waveform holds an inf:
    every rank skips the step and the weights stay equal on both ranks."""
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    cfg = {**CFG, "dropout": 0.0}
    torch.save(init_model(ModelConfig(**cfg), torch.Generator().manual_seed(0)).state_dict(),
               tmp_path / "init.pt")
    batch, parts = _ragged_batch()
    bad = _batch(8)
    bad["waveforms"][1, 10] = np.inf  # row 1: data rank 1's
    torch.save([parts, _slices(bad)], tmp_path / "two.pt")
    torch.save([[batch], [bad]], tmp_path / "one.pt")
    ranks = W.run_ranks(tmp_path, "train", 2, cfg=cfg, init=str(tmp_path / "init.pt"),
                        batches=str(tmp_path / "two.pt"), mesh_spec="data=2", grads=True)
    one = W.train(str(tmp_path), cfg, str(tmp_path / "init.pt"), str(tmp_path / "one.pt"),
                  grads=True)
    scale = max(float(g.abs().max()) for g in one["grads0"].values())
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], one["loss0"], rtol=1e-5)
        np.testing.assert_allclose(r["losses"][0], one["losses"][0], rtol=1e-5)
        assert not math.isfinite(r["losses"][1]) and not math.isfinite(one["losses"][1])
        for k, g in one["grads0"].items():
            torch.testing.assert_close(r["grads0"][k], g, rtol=0, atol=1e-5 * scale)
        got_params, got_state = jax_trees_from_state_dict(r["state"])
        want_params, want_state = jax_trees_from_state_dict(one["state"])
        _assert_params_close(got_params, want_params, got_state, want_state, _noise(one, 1))
    for k, v in ranks[1]["local_state"].items():
        assert torch.equal(v, ranks[0]["local_state"][k]), k
