"""The port's reader and writer of the JAX package's ``.ckpt`` against the
JAX package, on the CPU.

- ``utils/msgpack_read.unpackb`` equals ``flax.serialization.msgpack_restore``
  on files the JAX ``save_checkpoint_file`` writes (plain chain and
  accumulation 4 optimizer states, a bf16 leaf, numpy scalars and Python
  scalars of every kind in meta, ints of every msgpack width), and on
  arrays flax splits into chunks; an ext code flax never writes raises.
- ``save_jax_checkpoint_file`` with ``opt_named`` from the port's
  optimizer is read back by the JAX ``load_checkpoint_file(...,
  opt_state_template=...)``: after the same updates in both packages its
  moments equal optax's (the layout transforms of each moment); and the
  port restores it bit for bit.
- ``ASRInference`` serves a ``.ckpt``: fp32 logits within 1e-5 of the JAX
  ``apply_model`` on the same features (same fp32 arithmetic, summed in
  other orders), texts equal to the JAX ``ASRInference``'s, and the same
  from the server and ``python -m turkish_asr_torch.inference``.

Model: d_model 64, 2 heads, 2 blocks, 56 classes (``init_model`` from a
JAX key). Moments after the same updates: 1e-6 relative (the optimizer
tests' tolerance).
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import msgpack
import optax
import pytest
import torch
from flax import serialization

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import inference as jax_inference  # noqa: E402
from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig  # noqa: E402
from turkish_asr_tpu.models.conformer import apply_model  # noqa: E402
from turkish_asr_tpu.models.conformer import init_model as jax_init  # noqa: E402
from turkish_asr_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from turkish_asr_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from turkish_asr_tpu.utils.config import get_config as jax_get_config  # noqa: E402
from turkish_asr_torch import inference as port_inference  # noqa: E402
from turkish_asr_torch.audio.wavio import write_wav  # noqa: E402
from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig  # noqa: E402
from turkish_asr_torch.serve.server import ASRService, ServerConfig  # noqa: E402
from turkish_asr_torch.train.checkpoint import (  # noqa: E402
    latest_checkpoint, load_jax_checkpoint_file, save_jax_checkpoint_file)
from turkish_asr_torch.train.optim import make_optimizer  # noqa: E402
from turkish_asr_torch.utils import msgpack_read  # noqa: E402
from turkish_asr_torch.utils.weights import (  # noqa: E402
    load_ckpt, opt_named_from_optimizer, params_to_state_dict, restore_optimizer_from_named,
    state_dict_from_jax, trainable_names)

SR = 16000
CFG = dict(n_mels=80, d_model=64, n_heads=2, n_blocks=2, n_classes=56)
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
        -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
JaxASR = functools.partial(jax_inference.ASRInference, compute_dtype=jnp.float32,
                           use_pallas=False, data_parallel=False)
PortASR = functools.partial(port_inference.ASRInference, compute_dtype=torch.float32,
                            device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    return jax_init(jax.random.PRNGKey(1), JaxConfig(**CFG, dropout=0.0))


def _meta():
    return {"epoch": 3, "global_step": np.int32(7), "best_val_loss": np.float32(1.25),
            "loss": 2.5, "config": vars(jax_get_config([])), "ints": INTS,
            "flags": [True, False, None], "name": "ş" * 40, "blob": b"\x00\x01" * 200,
            "model_config": {**CFG, "dropout": 0.0, "masked_norm": False}}


def _assert_same(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("accum", [1, 4])
def test_reader_equals_msgpack_restore(tmp_path, jax_model, accum):
    params, state = jax_model
    params = jax.tree.map(lambda x: x, params)
    params["fc"]["b"] = params["fc"]["b"].astype(jnp.bfloat16)  # a bf16 leaf
    tx, _ = jax_make_optimizer(1e-3, 1e-6, 100, accumulation_steps=accum)
    path = str(tmp_path / "x.ckpt")
    jax_checkpoint.save_checkpoint_file(path, _meta(), params, state, tx.init(params))
    with open(path, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    got = msgpack_read.unpackb(blob)
    _assert_same(got, want)
    assert len(got["opt_named"]) == (130 if accum == 4 else 86)
    loaded = load_jax_checkpoint_file(path)
    assert set(loaded) == {"meta", "params", "model_state", "opt_named"}
    assert loaded["meta"]["ints"] == INTS


def test_chunked_arrays_are_reassembled(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into a dict of flat
    chunks (and writes a Python complex as ext 2); both readers give the
    tree back. The port's writer refuses such an array with a message."""
    tree = {"a": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "b": np.arange(7, dtype=np.int64), "c": {"d": np.ones((3, 50), np.float32)},
            "z": 1 + 2j}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_same(msgpack_read.unpackb(blob), serialization.msgpack_restore(blob))
    _assert_same(msgpack_read.unpackb(blob), tree)
    monkeypatch.setattr(msgpack_read, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="up to 64 bytes"):
        msgpack_read.packb(tree)


@pytest.mark.parametrize("blob,match", [
    (msgpack.packb(msgpack.ExtType(7, b"abc")), "ext type 7"),
    (b"\xc1", "starts no msgpack object"),
    (msgpack.packb({"a": [1, 2, 3]})[:-1], "ends inside"),
])
def test_reader_refuses_what_flax_never_writes(blob, match):
    with pytest.raises(ValueError, match=match):
        msgpack_read.unpackb(blob)


def test_writer_is_read_by_msgpack_restore():
    tree = {"meta": _meta(), "x": np.arange(6, dtype=np.int32).reshape(2, 3),
            "bf16": torch.arange(5, dtype=torch.float32).to(torch.bfloat16),
            "s": np.float64(2.5), "t": (1, 2)}
    got = serialization.msgpack_restore(msgpack_read.packb(tree))
    want = dict(tree, t=[1, 2])
    want["bf16"] = np.arange(5, dtype=np.float32).astype(got["bf16"].dtype)
    for k in ("meta", "x", "s", "t"):
        _assert_same(got[k], want[k])
    np.testing.assert_array_equal(got["bf16"].astype(np.float32), np.arange(5))
    _assert_same(msgpack_read.unpackb(msgpack_read.packb(tree))["meta"], tree["meta"])


def _port_model(params, state):
    model = ConformerCTC(ModelConfig(**CFG, dropout=0.0))
    model.load_state_dict(state_dict_from_jax(_np(params), _np(state), CFG["n_heads"]))
    return model


@pytest.mark.parametrize("accum,n", [(1, 3), (4, 6)])
def test_port_writer_is_read_by_the_jax_loader(tmp_path, jax_model, accum, n):
    """The same n gradient trees through optax and through the port's
    optimizer (each moment through its parameter's layout); the port
    writes a .ckpt, the JAX loader restores it with its template, and the
    moments, counts and window equal optax's. The port then restores the
    file into a fresh optimizer bit for bit."""
    params, state = jax_model
    tx, _ = jax_make_optimizer(1e-2, 1e-3, total_steps=20, accumulation_steps=accum)
    opt_state = tx.init(params)
    model = _port_model(params, state)
    names = trainable_names(model)
    opt, _ = make_optimizer([p for p in model.parameters() if p.requires_grad], 1e-2, 1e-3,
                            total_steps=20, accumulation_steps=accum)
    rng = np.random.default_rng(accum)

    @jax.jit
    def step(grads, opt_state, p):
        u, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, u), opt_state

    jp = params
    for _ in range(n):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
                             _np(params))
        jp, opt_state = step(jax.tree.map(jnp.asarray, grads), opt_state, jp)
        sd = params_to_state_dict(grads)
        opt.update([torch.tensor(sd[k]) for k in names])
    path = str(tmp_path / "port.ckpt")
    jax_params, jax_state = _np(params), _np(state)
    save_jax_checkpoint_file(path, {"epoch": 1, "global_step": opt.step_count}, jax_params,
                             jax_state, opt_named_from_optimizer(opt, model))
    ckpt = jax_checkpoint.load_checkpoint_file(path, opt_state_template=tx.init(params))
    want = dict(jax_checkpoint._named_leaves(opt_state))
    got = dict(jax_checkpoint._named_leaves(ckpt["opt_state"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for a, b in zip(jax.tree.leaves(ckpt["params"]), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, b)
    fresh, _ = make_optimizer([p for p in model.parameters() if p.requires_grad], 1e-2, 1e-3,
                              total_steps=20, accumulation_steps=accum)
    restore_optimizer_from_named(fresh, model, load_jax_checkpoint_file(path)["opt_named"])
    for a, b in zip(jax.tree.leaves(fresh.state_dict()), jax.tree.leaves(opt.state_dict())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_optimizer_state_mismatches_raise(tmp_path, jax_model):
    params, state = jax_model
    model = _port_model(params, state)
    trainable = [p for p in model.parameters() if p.requires_grad]
    plain, _ = make_optimizer(trainable, 1e-3, 0.0, 10)
    multi, _ = make_optimizer(trainable, 1e-3, 0.0, 10, accumulation_steps=4)
    with pytest.raises(KeyError, match="structure mismatch"):
        restore_optimizer_from_named(multi, model, opt_named_from_optimizer(plain, model))
    named = opt_named_from_optimizer(plain, model)
    key = "[1][0].mu['blocks']['attn']['k']['w']"
    named[key] = named[key].transpose(0, 2, 1)  # a transposed moment
    with pytest.raises(ValueError, match="shape"):
        restore_optimizer_from_named(plain, model, named)


def test_latest_checkpoint_takes_either_format(tmp_path):
    for i, name in enumerate(["checkpoint_epoch_1.pt", "checkpoint_epoch_2.ckpt",
                              "best_model.ckpt"]):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_epoch_2.ckpt")
    os.utime(tmp_path / "checkpoint_epoch_1.pt", (2000, 2000))
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_epoch_1.pt")


@pytest.fixture(scope="module")
def model_ckpt(tmp_path_factory, jax_model):
    params, state = jax_model
    path = str(tmp_path_factory.mktemp("model") / "best_model.ckpt")
    meta = {"epoch": 2, "global_step": 10, "best_val_loss": 3.0,
            "model_config": {**CFG, "dropout": 0.0, "masked_norm": False}}
    jax_checkpoint.save_checkpoint_file(path, meta, params, state)
    return path


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((1.0, 1.5, 2.5)):
        t = np.arange(int(seconds * SR)) / SR
        x = 0.3 * np.sin(2 * np.pi * (220 + 40 * np.floor(t * (3 + i))) * t)
        write_wav(str(d / f"s{i}.wav"),
                  (x + 0.05 * rng.standard_normal(t.shape)).astype(np.float32), SR)
    return str(d), [str(d / f"s{i}.wav") for i in range(3)]


def test_ckpt_logits_match_apply_model(model_ckpt, jax_model):
    params, state = jax_model
    cfg, model = load_ckpt(model_ckpt, "cpu", n_heads=99)  # the file's n_heads wins
    assert (cfg.n_heads, cfg.n_blocks, cfg.n_classes, cfg.use_mqa) == (2, 2, 56, True)
    x = np.random.default_rng(3).standard_normal((2, 124, 80)).astype(np.float32)
    lens = np.asarray([124, 77], np.int32)
    want, _ = apply_model(params, state, jnp.asarray(x), jnp.asarray(lens),
                          cfg=JaxConfig(**CFG, dropout=0.0), train=False,
                          compute_dtype=jnp.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lens), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_ckpt_without_model_state_gets_the_init_state(tmp_path, jax_model):
    params, _ = jax_model
    path = str(tmp_path / "no_state.ckpt")
    jax_checkpoint.save_checkpoint_file(path, {"model_config": CFG}, params, {})
    _, model = load_ckpt(path, "cpu")
    for i in range(CFG["n_blocks"]):
        bn = model.blocks[i].conv.batch_norm
        assert torch.equal(bn.running_mean, torch.zeros(64))
        assert torch.equal(bn.running_var, torch.ones(64))


def test_ckpt_is_served_as_jax_serves_it(model_ckpt, wavs):
    files = wavs[1]
    want = JaxASR(model_path=model_ckpt).transcribe_files(files, batch_size=4)
    port = PortASR(model_ckpt)
    assert port.transcribe_files(files, batch_size=4) == want
    assert any(want), "a random model should still emit some tokens"
    cfg = ServerConfig()
    cfg.MODEL_PATH = model_ckpt
    service = ASRService(cfg, warmup=False, device="cpu")
    service.asr.compute_dtype = torch.float32
    with open(files[0], "rb") as f:
        status, payload = service.transcribe_upload("s0.wav", f.read())
    assert status == 200 and payload["text"] == want[0]


def test_ckpt_vocabulary_is_checked(tmp_path, jax_model):
    params, state = jax_model
    other = jax_init(jax.random.PRNGKey(2), JaxConfig(**{**CFG, "n_classes": 40}, dropout=0.0))
    path = str(tmp_path / "v.ckpt")
    jax_checkpoint.save_checkpoint_file(path, {"model_config": {**CFG, "n_classes": 40}},
                                        *other)
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        PortASR(path)


def test_cli_prints_what_the_jax_cli_prints_for_a_ckpt(model_ckpt, wavs, capsys, monkeypatch):
    monkeypatch.setattr(jax_inference, "ASRInference", JaxASR)
    monkeypatch.setattr(port_inference, "ASRInference", PortASR)
    outputs = []
    for main, extra in ((jax_inference.main, []), (port_inference.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["inference.py", "--audio", wavs[0], "--model",
                                          model_ckpt] + extra)
        main()
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] and "Found 3 audio files" in outputs[0]
