"""Port's Conformer-CTC model and weight bridge against the JAX package.

Small config (d_model 64, 4 heads, 2 blocks, 80 mels, 56 classes). The
same JAX init goes through both packages.

Tolerances: fp32 logits within 1e-4 absolute (both sides are fp32
end to end; only summation order differs). bf16 logits within twice the
distance bf16 itself puts between the JAX package's bf16 and fp32 logits:
JAX and PyTorch round bf16 at different points (JAX keeps each dense
product in fp32 until the bias add, the port rounds it to bf16 first; XLA
fuses bf16 elementwise chains in fp32), so the two packages differ by
bf16 rounding noise of the same size as bf16 against fp32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig
from turkish_asr_tpu.models.conformer import apply_model, count_params as jax_count_params
from turkish_asr_tpu.models.conformer import init_model as jax_init
from turkish_asr_tpu.utils.torch_export import export_torch_state_dict
from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig, count_params, init_model
from turkish_asr_torch.utils.weights import config_from_state_dict, load_pt, state_dict_from_jax

CFG = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.0)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    params, state = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG))
    rng = np.random.default_rng(0)
    bn = state["blocks"]["bn"]
    # Non-trivial running statistics so BatchNorm is exercised.
    state = {"blocks": {"bn": {
        "mean": jnp.asarray(rng.standard_normal(bn["mean"].shape).astype(np.float32) * 0.1),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32))}}}
    return params, state


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 101, 80)).astype(np.float32)
    lens = np.asarray([101, 64, 9], np.int32)
    return x, lens


def _port_model(jax_model, masked_norm=False):
    params, state = jax_model
    model = ConformerCTC(ModelConfig(**CFG, masked_norm=masked_norm))
    model.load_state_dict(state_dict_from_jax(_to_np(params), _to_np(state), CFG["n_heads"]),
                          strict=True)
    return model.eval()


def test_state_dict_from_jax_equals_export(jax_model):
    params, state = jax_model
    want = export_torch_state_dict(params, state, CFG["n_heads"])
    got = state_dict_from_jax(_to_np(params), _to_np(state), CFG["n_heads"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)


def test_count_params_equals_the_jax_count(jax_model):
    """On the bridged weights: the trainable parameters, not the dead
    ``norm_conv`` GroupNorm the reference declares (no JAX leaf)."""
    model = _port_model(jax_model)
    assert count_params(model) == jax_count_params(jax_model[0])
    assert sum(p.numel() for p in model.parameters()) == (
        count_params(model) + 2 * CFG["d_model"] * CFG["n_blocks"])


def test_strict_load_covers_every_key(jax_model):
    sd = state_dict_from_jax(*_to_np(jax_model), CFG["n_heads"])
    model = ConformerCTC(ModelConfig(**CFG))
    assert sorted(model.state_dict()) == sorted(sd)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("masked_norm", [False, True])
def test_fp32_logits_match_jax(jax_model, batch, masked_norm):
    """All frames without masked_norm. With it, the valid frames: padded
    frames are normalized by statistics of the valid ones (4 values per
    group for the shortest row here), which amplifies rounding noise in
    outputs that no decode reads."""
    params, state = jax_model
    x, lens = batch
    want, new_state = apply_model(params, state, jnp.asarray(x), jnp.asarray(lens),
                                  cfg=JaxConfig(**CFG, masked_norm=masked_norm),
                                  train=False, compute_dtype=jnp.float32)
    model = _port_model(jax_model, masked_norm)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(lens), torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    frames = np.arange(got.shape[1])[None, :] < (lens // 4)[:, None]
    if not masked_norm:
        frames[:] = True
    np.testing.assert_allclose(got.numpy()[frames], np.asarray(want)[frames], atol=1e-4)
    # Eval passes BatchNorm state through unchanged, in both packages.
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(new_state), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_logits_close_to_jax(jax_model, batch):
    params, state = jax_model
    x, lens = batch
    want = {dt: np.asarray(apply_model(params, state, jnp.asarray(x), jnp.asarray(lens),
                                       cfg=JaxConfig(**CFG), train=False,
                                       compute_dtype=dt)[0])
            for dt in (jnp.bfloat16, jnp.float32)}
    with torch.inference_mode():
        got = _port_model(jax_model)(torch.from_numpy(x), torch.from_numpy(lens),
                                     torch.bfloat16).numpy()
    bf16_noise = np.abs(want[jnp.bfloat16] - want[jnp.float32]).max()
    assert 0 < bf16_noise < 0.1
    assert np.abs(got - want[jnp.bfloat16]).max() <= 2 * bf16_noise


def test_load_pt_round_trip(jax_model, tmp_path):
    from turkish_asr_tpu.utils.torch_export import export_torch_checkpoint
    params, state = jax_model
    path = str(tmp_path / "m.pt")
    export_torch_checkpoint(path, params, state, JaxConfig(**CFG))
    cfg, model = load_pt(path, "cpu")
    assert cfg == ModelConfig(**CFG)
    want = _port_model(jax_model).state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_config_from_bare_state_dict_rejects_mel_mismatch(jax_model):
    sd = state_dict_from_jax(*_to_np(jax_model), CFG["n_heads"])
    assert config_from_state_dict(sd) == ModelConfig(**CFG)
    with pytest.raises(ValueError, match="n_mel_channels"):
        config_from_state_dict(sd, n_mels=40)


def test_seeded_init_is_reproducible_and_bounded():
    cfg = ModelConfig(**CFG)
    a = init_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = init_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    bound = 1.0 / np.sqrt(CFG["d_model"] * 4)  # fan_in of ff1.linear2
    w = a["blocks.0.ff1.linear2.weight"]
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound


def test_a_served_forward_then_training_in_one_process():
    """A forward under torch.inference_mode (as the server runs it) first,
    then a training backward at the same length: the cached RoPE tables
    must be normal tensors, or autograd refuses to save them."""
    from turkish_asr_torch.models import attention
    attention.rope_cos_sin.cache_clear()
    cfg = ModelConfig(**CFG)
    model = init_model(cfg, torch.Generator().manual_seed(4))
    feats = torch.randn(2, 131, 80, generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([131, 90])
    with torch.inference_mode():
        model(feats, lengths, torch.float32)
    logits, _ = model(feats, lengths, torch.float32, train=True, seed=1)
    logits.square().mean().backward()
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
