"""The port's trainer resumes from the JAX trainer's ``.ckpt``, on the CPU.

The JAX ``Trainer`` takes 2 steps (accumulation 1, or 4 with the window
half full) and saves ``checkpoint_epoch_1.ckpt``; the port's trainer,
started from other weights with ``--resume`` on that directory, restores
the parameters, BatchNorm state, Adam moments and counts and MultiSteps'
window, and its next 3 steps follow the JAX trainer's next 3 on the same
batches (fp32, dropout 0, no augment). Tolerances are
tests/test_torch_train.py's: losses 1e-4 relative, weights 1e-5 absolute
(1% of the learning rate), the depthwise conv's bias (rounding noise fed
to Adam) within 3 learning rates and the BatchNorm mean that follows it.
A file without optimizer state takes the JAX step-offset rule; a
vocabulary mismatch raises before the optimizer is touched.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.data.tokenizer import TurkishTokenizer
from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig
from turkish_asr_tpu.models.conformer import init_model as jax_init
from turkish_asr_tpu.parallel.mesh import make_mesh, shard_batch
from turkish_asr_tpu.train import checkpoint as jax_checkpoint
from turkish_asr_tpu.train.optim import make_optimizer as jax_make_optimizer
from turkish_asr_tpu.train.trainer import Trainer as JaxTrainer
from turkish_asr_tpu.utils.config import get_config as jax_get_config
from turkish_asr_tpu.utils.logger import get_logger as jax_get_logger
from turkish_asr_torch.data.tokenizer import CharTokenizer
from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.train.optim import make_optimizer
from turkish_asr_torch.train.trainer import Trainer
from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.logger import get_logger
from turkish_asr_torch.utils.weights import jax_trees_from_state_dict, opt_named_from_optimizer

CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56)
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, B=2, S=8000):
    rng = np.random.default_rng(seed)
    return {"waveforms": (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
            "wav_lengths": np.asarray([S, S - 1500 * (seed % 3)], np.int32),
            "targets": rng.integers(2, 30, (B, 4)).astype(np.int32),
            "target_lengths": np.asarray([4, 3], np.int32),
            "sample_mask": np.ones((B,), np.float32)}


def _jax_trainer(tmp_path, accum):
    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG, dropout=0.0))
    tx, sched = jax_make_optimizer(LR, 1e-6, total_steps=100, accumulation_steps=accum)
    config = jax_get_config(["--accumulation_steps", str(accum), "--checkpoint_dir",
                             str(tmp_path), "--n_blocks", "2", "--d_model", "64"])
    return JaxTrainer(model_cfg=JaxConfig(**CFG, dropout=0.0), params=params, model_state=state,
                      optimizer=tx, schedule=sched, config=config,
                      logger=jax_get_logger(f"resume_ckpt.jax{accum}", str(tmp_path / "j.log")),
                      tokenizer=TurkishTokenizer(), mesh=make_mesh(None, devices=jax.devices()[:1]),
                      accumulation_steps=accum, compute_dtype=jnp.float32)


def _jax_step(jtr, i):
    jtr.params, jtr.model_state, jtr.opt_state, loss = jtr._train_step(
        jtr.params, jtr.model_state, jtr.opt_state, shard_batch(jtr.mesh, _batch(i)),
        jax.random.PRNGKey(i))
    return float(loss)


def _port_trainer(ckpt_dir, accum, n_classes=CFG["n_classes"]):
    model = init_model(ModelConfig(**{**CFG, "n_classes": n_classes}, dropout=0.0),
                       torch.Generator().manual_seed(7))
    config = get_config(["--accumulation_steps", str(accum), "--checkpoint_dir", str(ckpt_dir),
                         "--learning_rate", str(LR), "--resume"])
    opt, sched = make_optimizer([p for p in model.parameters() if p.requires_grad], LR,
                                config.weight_decay, total_steps=100, accumulation_steps=accum)
    logger = get_logger(f"resume_ckpt.port{accum}{n_classes}", log_file=str(ckpt_dir / "p.log"))
    return Trainer(model, opt, sched, config, logger, tokenizer=CharTokenizer(), device="cpu",
                   accumulation_steps=accum, compute_dtype=torch.float32)


@pytest.mark.parametrize("accum", [1, 4])
def test_port_resumes_the_jax_trainer(tmp_path, accum):
    jtr = _jax_trainer(tmp_path, accum)
    for i in range(2):
        _jax_step(jtr, i)
    jtr.save_checkpoint(1)
    port = _port_trainer(tmp_path, accum)
    port.load_checkpoint()
    jtr.sync_global_step()
    assert port.start_epoch == 2 and port.global_step == jtr.global_step == (2 if accum == 1
                                                                              else 0)
    saved = jax_checkpoint._named_leaves(jtr.opt_state)
    restored = opt_named_from_optimizer(port.optimizer, port.model)
    assert set(restored) == set(saved)
    for k, v in saved.items():  # the moments went through their parameters' layouts
        np.testing.assert_array_equal(restored[k], np.asarray(v), err_msg=k)
    for i in range(2, 5):
        want = _jax_step(jtr, i)
        got = port.train_step(_batch(i), seed=i)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    port.sync_global_step()
    jtr.sync_global_step()
    assert port.global_step == jtr.global_step
    got_params, got_state = jax_trees_from_state_dict(port.model.state_dict())
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


def test_ckpt_without_optimizer_state_takes_the_step_offset(tmp_path):
    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG, dropout=0.0))
    jax_checkpoint.save_checkpoint_file(
        str(tmp_path / "checkpoint_epoch_3.ckpt"),
        {"epoch": 3, "global_step": 7, "model_config": CFG}, params, {})
    port = _port_trainer(tmp_path, 1)
    port.load_checkpoint()
    assert (port.start_epoch, port.global_step, port.optimizer.step_count) == (4, 7, 0)
    bn = port.model.blocks[1].conv.batch_norm  # no model_state: the init state
    assert torch.equal(bn.running_var, torch.ones(64))
    port.train_step(_batch(0), seed=0)
    port.sync_global_step()
    assert port.global_step == 8


def test_vocabulary_mismatch_raises_before_the_optimizer(tmp_path):
    jtr = _jax_trainer(tmp_path, 4)
    _jax_step(jtr, 0)
    jtr.save_checkpoint(1)
    port = _port_trainer(tmp_path, 4, n_classes=40)
    before = [t.clone() for t in port.model.state_dict().values()]
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        port.load_checkpoint()
    opt = port.optimizer
    assert opt.mini_step == 0 and opt.inner.count == 0
    assert all(not a.any() for a in opt.acc + opt.inner.mu + opt.inner.nu)
    assert all(torch.equal(a, b) for a, b in zip(port.model.state_dict().values(), before))
