"""``python -m turkish_asr_torch.export_model`` on the CPU.

- ``--format export`` from a JAX ``.ckpt`` writes a ``.pt2`` whose graph
  holds the attention op ``turkish_asr_torch.flash_attention_fwd`` once a
  block; reloaded with ``torch.export.load``, it matches the eager model
  within 1e-5 (the same fp32 ops; the RoPE tables built by torch rather
  than numpy, within one fp32 ulp) at batch and time sizes it was not
  traced at.
- ``--format torch`` from the ``.ckpt`` writes the state dict the JAX
  ``export_model.export_torch`` writes, key for key (in another order) and bit for bit.
- ``stablehlo`` and ``savedmodel`` are refused with a message, and the
  default device is the card (no fallback to the CPU).

(The JAX package's tests/test_torch_export.py tests its own exporter.)
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import export_model as jax_export_model  # noqa: E402
from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig  # noqa: E402
from turkish_asr_tpu.models.conformer import init_model as jax_init  # noqa: E402
from turkish_asr_tpu.train.checkpoint import save_checkpoint_file  # noqa: E402
from turkish_asr_torch import export_model  # noqa: E402
from turkish_asr_torch.utils.weights import load_ckpt  # noqa: E402

CFG = dict(n_mels=80, d_model=64, n_heads=2, n_blocks=2, n_classes=56)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params, state = jax_init(jax.random.PRNGKey(4), JaxConfig(**CFG, dropout=0.0))
    path = str(tmp_path_factory.mktemp("ckpt") / "best_model.ckpt")
    save_checkpoint_file(path, {"model_config": {**CFG, "dropout": 0.0}}, params, state)
    return path


def test_export_program_holds_the_attention_op(ckpt, tmp_path, capsys):
    out = str(tmp_path / "model.pt2")
    export_model.main(["--checkpoint", ckpt, "--output", out, "--device", "cpu"])
    assert "Verification passed." in capsys.readouterr().out
    program = torch.export.load(out)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "turkish_asr_torch.flash_attention_fwd" in str(n.target)]
    assert len(nodes) == CFG["n_blocks"]
    _, model = load_ckpt(ckpt, "cpu")
    run = program.module()
    rng = np.random.default_rng(1)
    for B, T in ((1, 64), (3, 152)):
        x = torch.from_numpy(rng.standard_normal((B, T, 80)).astype(np.float32))
        with torch.no_grad():
            got, want = run(x), model(x, None, torch.float32)
        assert got.shape == (B, T // 4, CFG["n_classes"])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_torch_format_matches_the_jax_exporter(ckpt, tmp_path):
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    export_model.main(["--checkpoint", ckpt, "--output", ours, "--format", "torch",
                       "--device", "cpu"])
    jax_export_model.export_torch(ckpt, theirs, n_heads=CFG["n_heads"],
                                  n_blocks=CFG["n_blocks"], d_model=CFG["d_model"])
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    assert set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    assert {k: got["config"][k] for k in want["config"]} == want["config"]


@pytest.mark.parametrize("fmt", ["stablehlo", "savedmodel"])
def test_jax_formats_are_refused(ckpt, tmp_path, fmt, capsys):
    with pytest.raises(SystemExit):
        export_model.main(["--checkpoint", ckpt, "--output", str(tmp_path / "x"),
                           "--format", fmt, "--device", "cpu"])
    assert "needs jax" in capsys.readouterr().err
    with pytest.raises(ValueError, match="never imports"):
        export_model.export_model(ckpt, str(tmp_path / "x"), fmt, device="cpu")


def test_export_defaults_to_the_card(ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        export_model.main(["--checkpoint", ckpt, "--output", str(tmp_path / "m.pt2")])
