"""The port's training path (train/, models/ in train mode, main.py)
against the JAX package's, on the CPU at a small size.

- the OneCycle schedule against JAX ``torch_onecycle_schedule`` (fp32);
- clip + AdamW updates, ``MultiSteps`` accumulation and the epoch-end
  flush against the optax chain of ``make_optimizer``;
- the train-mode forward (BatchNorm batch statistics, masked or not)
  against ``apply_model(train=True)``;
- a 5-step trajectory (accumulation 2, then the flush; dropout 0, no
  augment, fp32) against the JAX ``Trainer``: losses, weights, BatchNorm;
- recomputation on and off, with dropout on, give the same gradients and
  BatchNorm statistics; a NaN batch changes nothing; save -> resume
  continues bit for bit; the written .pt is served by ``ASRInference``;
  ``main`` trains, resumes and refuses the TPU-only flags (``--profile_dir``
  and ``--remat_policy dots`` run: tests/test_torch_remat_profile.py).

Tolerances: the schedule and optimizer run the same fp32 formulas: 1e-6
relative. Forward logits: 1e-4 absolute (fp32, summation order). The
trajectory: losses 1e-4 relative; weights 1e-5 absolute, which is 1% of
the learning rate here: Adam divides each gradient by its own root mean
square, so an element whose gradient is near rounding noise may move by a
fraction of the learning rate differently in the two packages.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig
from turkish_asr_tpu.models.conformer import apply_model, init_model as jax_init
from turkish_asr_tpu.train.optim import make_optimizer as jax_make_optimizer
from turkish_asr_tpu.train.optim import torch_onecycle_schedule as jax_schedule
from turkish_asr_torch.audio.wavio import write_wav
from turkish_asr_torch.data.tokenizer import CharTokenizer
from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig, init_model
from turkish_asr_torch.parallel.mesh import make_mesh
from turkish_asr_torch.train.optim import (
    ClippedAdamW, MultiSteps, make_optimizer, torch_onecycle_schedule)
from turkish_asr_torch.train.trainer import Trainer
from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.logger import get_logger
from turkish_asr_torch.utils.weights import jax_trees_from_state_dict, state_dict_from_jax

# d_model 64: GroupNorm's 32 groups then hold two channels each. At d_model
# 32 every channel is its own group, a per-channel shift of the residual
# stream is normalized away exactly, and the biases that add one get pure
# rounding noise as gradient, which Adam turns into steps of +-lr.
CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=1, n_classes=56)
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, B=2, S=8000, bad=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    if bad:
        w[0, 0] = np.inf
    return {"waveforms": w,
            "wav_lengths": np.asarray([S, S - 1500 * (seed % 3)], np.int32)[:B],
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3], np.int32)[:B],
            "sample_mask": np.ones((B,), np.float32)}


def _port_trainer(tmp_path, model, accum=1, name="port", argv=()):
    tmp_path.mkdir(parents=True, exist_ok=True)
    config = get_config(["--accumulation_steps", str(accum), "--checkpoint_dir", str(tmp_path),
                         "--learning_rate", str(LR), *argv])
    opt, sched = make_optimizer([p for p in model.parameters() if p.requires_grad], LR,
                                config.weight_decay, total_steps=100,
                                accumulation_steps=accum)
    logger = get_logger(f"test_torch_train.{name}", log_file=str(tmp_path / "t.log"))
    return Trainer(model, opt, sched, config, logger, tokenizer=CharTokenizer(), device="cpu",
                   accumulation_steps=accum, compute_dtype=torch.float32)


def _jax_model(dropout=0.0):
    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG, dropout=dropout))
    return params, state


def _port_model(params, state, dropout=0.0, masked_norm=False):
    model = ConformerCTC(ModelConfig(**CFG, dropout=dropout, masked_norm=masked_norm))
    model.load_state_dict(state_dict_from_jax(_np(params), _np(state), CFG["n_heads"]))
    return model


def test_schedule_matches_jax():
    for total in (10, 37, 100):
        got = torch_onecycle_schedule(5e-4, total)
        want = jax_schedule(5e-4, total)
        for count in range(total + 3):  # fp32: 1e-6 of the peak (1 + cos cancels near pi)
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=5e-10)


def _optax_run(grads_seq, params, accum, flush=0):
    tx, _ = jax_make_optimizer(1e-2, 1e-3, total_steps=20, gradient_clip=1.0,
                               accumulation_steps=accum)
    state = tx.init(params)
    for g in list(grads_seq) + [jax.tree.map(jnp.zeros_like, params)] * flush:
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    return _np(params)


@pytest.mark.parametrize("accum,n", [(1, 3), (3, 7)])
def test_updates_match_optax(accum, n):
    """Three plain updates, one with a gradient norm under the clip; or
    seven micro-gradients under accumulation 3, then the flush of the
    partial window (the diluted mean, one more schedule step)."""
    rng = np.random.default_rng(accum)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (0.1 if i == 1 else 2.0)).astype(np.float32)
              for k, v in init.items()} for i in range(n)]
    params = [torch.tensor(init["a"]), torch.tensor(init["b"])]
    opt, _ = make_optimizer(params, 1e-2, 1e-3, total_steps=20, accumulation_steps=accum)
    for g in grads:
        opt.update([torch.tensor(g["a"]), torch.tensor(g["b"])])
    flushed = opt.flush() if accum > 1 else False
    want = _optax_run([jax.tree.map(jnp.asarray, g) for g in grads],
                      jax.tree.map(jnp.asarray, init), accum,
                      flush=(accum - n % accum) % accum)
    np.testing.assert_allclose(params[0].numpy(), want["a"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(params[1].numpy(), want["b"], rtol=1e-6, atol=1e-7)
    assert opt.step_count == math.ceil(n / accum) and flushed == (accum > 1)


@pytest.mark.parametrize("masked_norm", [False, True])
def test_train_forward_matches_jax(masked_norm):
    params, state = _jax_model()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 61, 80)).astype(np.float32)
    lens = np.asarray([61, 40, 9], np.int32)
    want, want_state = apply_model(params, state, jnp.asarray(x), jnp.asarray(lens),
                                   cfg=JaxConfig(**CFG, dropout=0.0, masked_norm=masked_norm),
                                   train=True, compute_dtype=jnp.float32)
    model = _port_model(params, state, masked_norm=masked_norm)
    got, bn = model(torch.from_numpy(x), torch.from_numpy(lens), torch.float32, train=True)
    # With masked_norm, the valid frames (padded ones are normalized by the
    # valid frames' statistics, which amplifies rounding in outputs no
    # decode reads; as tests/test_torch_model.py).
    frames = np.arange(got.shape[1])[None, :] < (lens // 4)[:, None] if masked_norm else ...
    np.testing.assert_allclose(got.detach().numpy()[frames], np.asarray(want)[frames],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(bn[0][0].numpy(), np.asarray(want_state["blocks"]["bn"]["mean"][0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn[0][1].numpy(), np.asarray(want_state["blocks"]["bn"]["var"][0]),
                               rtol=1e-5, atol=1e-5)


def test_trajectory_matches_jax_trainer(tmp_path):
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer
    from turkish_asr_tpu.parallel.mesh import make_mesh, shard_batch
    from turkish_asr_tpu.train.trainer import Trainer as JaxTrainer
    from turkish_asr_tpu.utils.config import get_config as jax_get_config
    from turkish_asr_tpu.utils.logger import get_logger as jax_get_logger

    params, state = _jax_model()
    port = _port_trainer(tmp_path, _port_model(params, state), accum=2)
    tx, sched = jax_make_optimizer(LR, 1e-6, total_steps=100, accumulation_steps=2)
    jtr = JaxTrainer(model_cfg=JaxConfig(**CFG, dropout=0.0), params=params, model_state=state,
                     optimizer=tx, schedule=sched,
                     config=jax_get_config(["--accumulation_steps", "2"]),
                     logger=jax_get_logger("test_torch_train.jax", str(tmp_path / "j.log")),
                     tokenizer=TurkishTokenizer(), mesh=make_mesh(None, devices=jax.devices()[:1]),
                     accumulation_steps=2, compute_dtype=jnp.float32)
    for i in range(5):
        batch = _batch(i)
        jtr.params, jtr.model_state, jtr.opt_state, jloss = jtr._train_step(
            jtr.params, jtr.model_state, jtr.opt_state, shard_batch(jtr.mesh, batch),
            jax.random.PRNGKey(i))
        loss = port.train_step(batch, seed=i)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    jtr.flush_accumulation()
    port.flush_accumulation()
    jtr.sync_global_step()
    assert port.global_step == jtr.global_step == 3
    got_params, got_state = jax_trees_from_state_dict(port.model.state_dict())
    # The depthwise conv's bias feeds BatchNorm in train mode, which removes
    # a per-channel shift exactly: its gradient is rounding noise in both
    # packages, and Adam turns noise into steps of +-lr. It is left out.
    # The BatchNorm running mean follows that bias (momentum 0.1 of each
    # step's shift), so it may differ by up to the bias's own difference;
    # the running variance does not see it.
    want_params = _np(jtr.params)
    bias_diff = np.abs(got_params["blocks"]["conv"]["dw"]["b"]
                       - want_params["blocks"]["conv"]["dw"]["b"]).max()
    assert bias_diff <= 3 * LR
    for tree in (got_params, want_params):
        del tree["blocks"]["conv"]["dw"]["b"]
    for a, b in zip(jax.tree.leaves(got_params), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    want_state = _np(jtr.model_state)["blocks"]["bn"]
    np.testing.assert_allclose(got_state["blocks"]["bn"]["mean"], want_state["mean"], rtol=0,
                               atol=bias_diff + 1e-6)
    np.testing.assert_allclose(got_state["blocks"]["bn"]["var"], want_state["var"], rtol=1e-5,
                               atol=1e-6)


def _grads_and_bn(model, batch, remat):
    feats = torch.randn(2, 61, 80, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([61, 33])
    logits, bn = model(feats, lens, torch.float32, train=True, seed=99, remat=remat)
    (logits.square().mean()).backward()
    grads = [p.grad.clone() for p in model.parameters() if p.requires_grad]
    model.zero_grad()
    return grads, bn


def test_remat_gives_the_same_gradients_with_dropout():
    """Per-block recomputation draws the same dropout masks as the first
    forward (seeds derived from step, block, site), so the gradients and
    the returned BatchNorm statistics equal the run without it."""
    model = init_model(ModelConfig(**{**CFG, "n_blocks": 2}, dropout=0.3),
                       torch.Generator().manual_seed(0))
    g0, bn0 = _grads_and_bn(model, None, remat=False)
    g1, bn1 = _grads_and_bn(model, None, remat=True)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(bn0, bn1):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    other, _ = model(torch.zeros(2, 61, 80), torch.tensor([61, 33]), torch.float32,
                     train=True, seed=100)
    same, _ = model(torch.zeros(2, 61, 80), torch.tensor([61, 33]), torch.float32,
                    train=True, seed=99)
    assert not torch.equal(other, same)  # the seed keys the masks


def test_nan_batch_changes_nothing(tmp_path):
    tr = _port_trainer(tmp_path, init_model(ModelConfig(**CFG, dropout=0.1),
                                            torch.Generator().manual_seed(0)), accum=2)
    tr.train_step(_batch(0), seed=0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = tr.optimizer.state_dict()
    loss = tr.train_step(_batch(1, bad=True), seed=1)
    assert not math.isfinite(loss)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    after = tr.optimizer.state_dict()
    assert after["mini_step"] == opt_before["mini_step"] == 1
    for a, b in zip(after["acc"], opt_before["acc"]):
        assert torch.equal(a, b)


def _epoch(tr, epoch, n=3):
    tr.train_loader = [_batch(10 * epoch + i) for i in range(n)]
    tr.train_epoch(epoch)


def test_save_resume_continues_bit_for_bit(tmp_path):
    cfg = ModelConfig(**CFG, dropout=0.1)
    straight = _port_trainer(tmp_path / "a", init_model(cfg, torch.Generator().manual_seed(0)),
                             accum=2, name="a", argv=["--augment"])
    straight.augment = True
    _epoch(straight, 1)
    _epoch(straight, 2)
    first = _port_trainer(tmp_path / "b", init_model(cfg, torch.Generator().manual_seed(0)),
                          accum=2, name="b")
    first.augment = True
    _epoch(first, 1)
    first.save_checkpoint(1)
    resumed = _port_trainer(tmp_path / "b", init_model(cfg, torch.Generator().manual_seed(5)),
                            accum=2, name="b2", argv=["--resume"])
    resumed.augment = True
    resumed.load_checkpoint()
    assert resumed.start_epoch == 2 and resumed.global_step == first.global_step == 2
    _epoch(resumed, 2)
    want = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed.losses == straight.losses[3:]


def test_resume_refuses_another_vocabulary(tmp_path):
    tr = _port_trainer(tmp_path, init_model(ModelConfig(**{**CFG, "n_classes": 99})), name="v")
    tr.save_checkpoint(1)
    other = _port_trainer(tmp_path, init_model(ModelConfig(**CFG)), name="v2",
                          argv=["--resume"])
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        other.load_checkpoint()


def _corpus(root, n=8):
    root.mkdir()
    for i, word in enumerate(["merhaba", "evet", "bir", "iki", "üç", "dört", "beş", "altı"][:n]):
        t = np.arange(8000) / 16000
        write_wav(str(root / f"s{i}.wav"),
                  (0.3 * np.sin(2 * np.pi * (180 + 90 * i) * t)).astype(np.float32), 16000)
        (root / f"s{i}.txt").write_text(word, encoding="utf-8")


def test_main_trains_resumes_and_serves(tmp_path):
    from turkish_asr_torch.inference import ASRInference
    from turkish_asr_torch.main import main

    _corpus(tmp_path / "corpus")
    argv = ["--data_path", str(tmp_path / "corpus"), "--val_split", "0.25", "--test_split", "0",
            "--checkpoint_dir", str(tmp_path / "runs"), "--d_model", "32", "--n_heads", "2",
            "--n_blocks", "1", "--batch_size", "3", "--learning_rate", "2e-3",
            "--save_interval", "1", "--log_interval", "1", "--device", "cpu", "--augment",
            "--accumulation_steps", "2", "--num_workers", "2"]
    tr = main(argv + ["--epochs", "1"])
    assert len(tr.losses) == 2 and all(math.isfinite(x) for x in tr.losses)
    assert tr.global_step == 1
    resumed = main(argv + ["--epochs", "2", "--resume"])
    assert resumed.start_epoch == 2 and resumed.global_step == 2
    names = sorted(p.name for p in (tmp_path / "runs").iterdir())
    assert {"checkpoint_epoch_1.pt", "checkpoint_epoch_2.pt", "best_model.pt",
            "turkish_conformer_final.pt", "train.log"} <= set(names)
    asr = ASRInference(str(tmp_path / "runs" / "turkish_conformer_final.pt"), device="cpu",
                       compute_dtype=torch.float32)
    assert isinstance(asr.transcribe(str(tmp_path / "corpus" / "s0.wav")), str)
    for k, v in asr.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


@pytest.mark.parametrize("flag", [["--use_pallas"], ["--ctc_impl", "scan"], ["--mesh_shape", "data=4"],
                                  ["--distributed"], ["--rng_impl", "threefry2x32"]])
def test_tpu_only_flags_are_refused(flag):
    """The TPU-only flags are refused. The multi-device flags are ported:
    they parse, and a mesh the world size cannot hold is refused by the
    mesh, as JAX ``make_mesh`` refuses it."""
    if flag[0] in ("--mesh_shape", "--distributed"):
        config = get_config(flag)
        assert (config.mesh_shape, config.distributed) == (
            ("data=4", False) if flag[0] == "--mesh_shape" else (None, True))
        if config.mesh_shape:
            with pytest.raises(ValueError, match="mesh data=4 needs 4 devices, have 1"):
                make_mesh(config.mesh_shape, 1)
    else:
        with pytest.raises(ValueError, match="not applicable"):
            get_config(flag)
    defaults = get_config([])
    assert (defaults.batch_size, defaults.encoder_dropout, defaults.learning_rate) == (32, 0.1, 5e-4)


def test_weight_trees_round_trip():
    params, state = _jax_model()
    sd = state_dict_from_jax(_np(params), _np(state), CFG["n_heads"])
    got_params, got_state = jax_trees_from_state_dict(sd)
    assert jax.tree.structure(got_params) == jax.tree.structure(_np(params))
    for a, b in zip(jax.tree.leaves(got_params) + jax.tree.leaves(got_state),
                    jax.tree.leaves(_np(params)) + jax.tree.leaves(_np(state))):
        np.testing.assert_array_equal(a, b)


def test_optimizer_state_round_trip():
    p = [torch.ones(3), torch.ones(2)]
    a = MultiSteps(ClippedAdamW(p, lambda c: 1e-3, 0.0), 2)
    a.update([torch.ones(3), torch.ones(2)])
    b = MultiSteps(ClippedAdamW([torch.ones(3), torch.ones(2)], lambda c: 1e-3, 0.0), 2)
    b.load_state_dict(a.state_dict())
    assert b.mini_step == 1 and torch.equal(b.acc[0], a.acc[0])
    with pytest.raises(ValueError, match="moments"):
        ClippedAdamW([torch.ones(3)], lambda c: 1e-3, 0.0).load_state_dict(a.inner.state_dict())
