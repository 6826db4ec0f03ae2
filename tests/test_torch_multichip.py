"""The port's multi-rank layer beyond the meshes of test_torch_parallel*.py:
``turkish_asr_torch.multichip`` (the counterpart of ``__graft_entry__.dryrun_multichip``), its launcher,
and the model x seq meshes against one process and the JAX trainer.

- ``python -m turkish_asr_torch.multichip 4 --device cpu`` starts four
  gloo ranks itself (TCP on 127.0.0.1, as torchrun would) and prints the
  JAX dryrun's mesh ``{'data': 2, 'model': 2}``, a finite loss and trie ==
  hash over the batch's rows; ``choose_mesh`` is the JAX dryrun's rule.
- ``model=2,seq=2`` (4 ranks) and ``data=2,model=2,seq=2`` (8 ranks, the JAX
  dryrun's mesh at n=8) follow the port's one-process step at fp32 and
  dropout 0: losses within rtol 1e-4, the first step's gradients within
  rtol 1e-3 / atol 1e-4 (tests/test_torch_parallel_tp.py's tolerances),
  the gathered initial state equal to the init; and they follow the JAX
  one-device ``Trainer`` on the same weights (the weight bridge) for 3
  steps: losses within rtol 1e-4, weights within 1e-4 absolute (the
  model and seq meshes' gate in tests/test_torch_parallel_tp.py and
  chip_smoke.py; the rounding-noise elements of
  tests/test_torch_parallel.py within 3 lr).
- the model and seq ranks of a data line train on its first rank's rows,
  whatever rows their loaders gave them.
- the launcher stops every rank and raises when one exits non-zero or
  the ranks outlast their timeout; ``--device cuda`` raises without cards.
- the barrier names this rank's card under NCCL.

The training scenarios run on tests/torch_parallel_worker.py's gloo ranks
(a FileStore in the test's tmp dir, one thread a rank, a timeout).
"""

import math
import os
import re
import subprocess
import sys
import time

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
from turkish_asr_torch import multichip  # noqa: E402
from turkish_asr_torch.utils.weights import (  # noqa: E402
    jax_trees_from_state_dict, state_dict_from_jax)
import torch_parallel_worker as W  # noqa: E402
from test_torch_parallel import _assert_params_close, _noise, _np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56)
LR = 1e-3


def test_multichip_cli_on_four_gloo_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("RANK", None)
    out = subprocess.run([sys.executable, "-m", "turkish_asr_torch.multichip", "4",
                          "--device", "cpu", "--timeout", "150"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    step = re.search(r"^dryrun_multichip\(4\): mesh=(\{.*\}) loss=(\S+)$", out.stdout, re.M)
    assert step and step.group(1) == "{'data': 2, 'model': 2}", out.stdout
    assert math.isfinite(float(step.group(2)))
    assert "dryrun_multichip(4): mesh beam+LM decode ok (trie==hash over 4 sharded rows" \
        in out.stdout


@pytest.mark.parametrize("n, spec", [(1, "data=1"), (2, "data=2"), (3, "data=3"),
                                     (4, "data=2,model=2"), (6, "data=3,model=2"),
                                     (8, "data=2,model=2,seq=2"), (12, "data=6,model=2"),
                                     (16, "data=4,model=2,seq=2")])
def test_dryrun_mesh_is_the_jax_dryruns(n, spec):
    """__graft_entry__.py:106-113's choice, and a spec JAX's make_mesh
    lays out over n devices as the port's does."""
    assert multichip.choose_mesh(n) == spec
    from turkish_asr_torch.parallel.mesh import make_mesh
    if n <= len(jax.devices()):
        want = jax_make_mesh(spec, devices=jax.devices()[:n])
        assert make_mesh(spec, n).sizes == want.devices.shape


def test_dryrun_alone_without_a_process_group():
    out = multichip.dryrun_multichip(1, "cpu")
    assert out["mesh"] == {"data": 1} and math.isfinite(out["loss"])
    assert out["B"] == 4 and len(out["texts"]) == 4


def _batch(seed, B=4, S=8000):
    """S = 8000 samples: T' = 13 for the longest row, odd, so seq=2
    splits it 7 and 6."""
    rng = np.random.default_rng(seed)
    return {"waveforms": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
            "wav_lengths": np.asarray([S, S - 2600, S - 1000, S - 2000], np.int32)[:B],
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3, 2, 4], np.int32)[:B],
            "sample_mask": np.ones((B,), np.float32)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX-initialized weights, 3 global batches, the port's one-process
    run and the JAX one-device trainer's 3 steps on them."""
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer
    from turkish_asr_tpu.parallel.mesh import shard_batch
    from turkish_asr_tpu.train.trainer import Trainer as JaxTrainer
    from turkish_asr_tpu.utils.config import get_config as jax_get_config
    from turkish_asr_tpu.utils.logger import get_logger as jax_get_logger

    tmp = tmp_path_factory.mktemp("multichip")
    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG, dropout=0.0))
    torch.save(state_dict_from_jax(_np(params), _np(state), CFG["n_heads"]), tmp / "init.pt")
    batches = [_batch(i) for i in range(3)]
    torch.save([[b] for b in batches], tmp / "one.pt")
    torch.save([[{k: v[d::2] for k, v in b.items()} for d in range(2)] for b in batches],
               tmp / "two.pt")
    cfg = {**CFG, "dropout": 0.0}
    one = W.train(str(tmp), cfg, str(tmp / "init.pt"), str(tmp / "one.pt"), grads=True)

    tx, sched = jax_make_optimizer(LR, 1e-6, total_steps=100)
    jtr = JaxTrainer(model_cfg=JaxConfig(**CFG, dropout=0.0), params=params, model_state=state,
                     optimizer=tx, schedule=sched, config=jax_get_config([]),
                     logger=jax_get_logger("test_torch_multichip.jax", str(tmp / "j.log")),
                     tokenizer=TurkishTokenizer(),
                     mesh=jax_make_mesh(None, devices=jax.devices()[:1]),
                     compute_dtype=jnp.float32)
    jlosses = []
    for i, batch in enumerate(batches):
        jtr.params, jtr.model_state, jtr.opt_state, jloss = jtr._train_step(
            jtr.params, jtr.model_state, jtr.opt_state, shard_batch(jtr.mesh, batch),
            jax.random.PRNGKey(i))
        jlosses.append(float(jloss))
    return tmp, cfg, one, (jlosses, _np(jtr.params), _np(jtr.model_state))


@pytest.mark.parametrize("world, spec", [(4, "model=2,seq=2"), (8, "data=2,model=2,seq=2")])
def test_model_and_seq_meshes_follow_one_process_and_jax(setup, world, spec):
    tmp, cfg, one, (jlosses, jparams, jstate) = setup
    batches = tmp / ("two.pt" if spec.startswith("data") else "one.pt")
    ranks = W.run_ranks(tmp, "train", world, timeout=150, cfg=cfg, init=str(tmp / "init.pt"),
                        batches=str(batches), mesh_spec=spec, grads=True)
    init = torch.load(tmp / "init.pt", weights_only=True)
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], one["loss0"], rtol=1e-4)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        for k, g in one["grads0"].items():
            torch.testing.assert_close(r["grads0"][k], g, rtol=1e-3, atol=1e-4)
        assert r["state_init"].keys() == init.keys()
        for k, v in init.items():
            assert torch.equal(r["state_init"][k], v), k
    got_params, got_state = jax_trees_from_state_dict(ranks[0]["state"])
    # The model and seq meshes' weight gate (test_torch_parallel_tp.py's
    # data=2,model=2 test and chip_smoke.py's): 1e-4 absolute, 10% of lr.
    _assert_params_close(got_params, jparams, got_state, jstate, _noise(ranks[0], 3), atol=1e-4)
    for r in ranks[1:]:  # every rank gathers the same full state
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k


@pytest.mark.parametrize("world, spec", [(2, "model=2"), (4, "model=2,seq=2")])
def test_a_data_line_trains_on_its_first_ranks_rows(setup, tmp_path, world, spec):
    """The model and seq ranks of a data line load the same rows, but a
    loader's host augmentation (speed perturbation, drawn from a generator
    its threads share) can hand them other waveforms, even of another
    length. Every rank here gets other rows than rank 0: each trains on
    rank 0's, the one-process run's losses and gradients."""
    tmp, cfg, one, _ = setup
    first = [_batch(i) for i in range(3)]
    others = [{**_batch(10 + i, S=6400), "wav_lengths": np.asarray([6400, 5000, 3900, 6000],
                                                                   np.int32)}
              for i in range(3)]
    torch.save([[a] + [b] * (world - 1) for a, b in zip(first, others)], tmp_path / "r.pt")
    ranks = W.run_ranks(tmp_path, "train", world, timeout=150, cfg=cfg,
                        init=str(tmp / "init.pt"), batches=str(tmp_path / "r.pt"),
                        mesh_spec=spec, grads=True, by_rank=True)
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], one["loss0"], rtol=1e-4)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        for k, g in one["grads0"].items():
            torch.testing.assert_close(r["grads0"][k], g, rtol=1e-3, atol=1e-4)


def _rank_code(tmp_path, body):
    """A rank's program: write its pid to ``pid<RANK>``, then ``body``;
    ``wait(r)`` waits for rank r's pid file (ranks start in any order)."""
    return ("import os, sys, time\n"
            f"d = {str(tmp_path)!r}\n"
            "open(os.path.join(d, 'pid' + os.environ['RANK']), 'w').write(str(os.getpid()))\n"
            "def wait(r):\n"
            "    while not os.path.exists(os.path.join(d, 'pid%d' % r)):\n"
            "        time.sleep(0.05)\n" + body)


def test_launcher_stops_every_rank_when_one_raises(tmp_path):
    """Rank 1 raises while rank 0 waits (as in a collective): the launcher
    kills rank 0 and raises at once, long before its timeout."""
    code = _rank_code(tmp_path, "if os.environ['RANK'] == '1':\n"
                                "    wait(0)\n    raise SystemExit(3)\n"
                                "time.sleep(600)\n")
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        multichip.launch([sys.executable, "-c", code], 2, "cpu", timeout=120)
    assert time.monotonic() - start < 60
    _assert_gone(int((tmp_path / "pid0").read_text()))


def test_launcher_kills_hung_ranks_at_its_timeout(tmp_path):
    code = _rank_code(tmp_path, "assert os.environ['MASTER_ADDR'] == '127.0.0.1'\n"
                                "assert os.environ['WORLD_SIZE'] == '2'\n"
                                "if os.environ['RANK'] == '1':\n    time.sleep(600)\n"
                                "wait(1)\n")
    with pytest.raises(TimeoutError, match="outlasted 15 s"):
        multichip.launch([sys.executable, "-c", code], 2, "cpu", timeout=15)
    _assert_gone(int((tmp_path / "pid1").read_text()))


def _assert_gone(pid):
    """The launcher has reaped ``pid``: it no longer exists."""
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_cuda_ranks_need_cards(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="4 ranks on CUDA need 4 visible cards"):
        multichip.main(["4", "--device", "cuda"])


def test_barrier_names_the_ranks_card_under_nccl(monkeypatch):
    """NCCL's barrier guesses the card from the rank without ``device_ids``
    (torch.distributed.barrier's note); the port passes its own."""
    from turkish_asr_torch.parallel import mesh
    calls = []
    monkeypatch.setattr(mesh.dist, "barrier", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    for backend in ("nccl", "gloo"):
        monkeypatch.setattr(mesh.dist, "get_backend", lambda b=backend: b)
        mesh.barrier()
    assert calls == [{"device_ids": [3]}, {}]
