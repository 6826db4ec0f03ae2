"""The port's Conformer (L) block (``ModelConfig(block="conformer")``) on the
CPU, at a small size (d 64, 4 heads, 2 blocks) on seeded random weights,
against the plain reference ``tests/ref_conformer_l.py`` and the
benchmark's copy of it.

Tolerances: the port and the references compute the same fp32 function
with the same operations in other orders (the port's relative term
gathers one column per (i, j) where the references rel-shift, its LayerNorm
is ``F.layer_norm``, its even depthwise kernel pads 16 on both sides and
drops the first output where the references pad 15/16), so logits agree
within 1e-4 absolute, the model tests' fp32 tolerance; the attention op
alone within 1e-5. A file's logits alone and in a padded batch of a longer
bucket differ only by the summation orders of other matrix shapes: 1e-4.
"""

import os
import sys
import wave

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ref_conformer_l  # noqa: E402
from asr_bench.reference import conformer_l as bench_reference  # noqa: E402
from turkish_asr_torch.inference import ASRInference  # noqa: E402
from turkish_asr_torch.models.conformer import (  # noqa: E402
    ConformerCTC, ModelConfig, count_params, init_model)
from turkish_asr_torch.ops import relpos_attention as rp  # noqa: E402
from turkish_asr_torch.ops._relpos_attention import relpos_attention_ref  # noqa: E402
from turkish_asr_torch.utils import tracing  # noqa: E402
from turkish_asr_torch.utils.weights import load_pt  # noqa: E402

SMALL = dict(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.0,
             block="conformer")


def _model(kernel_size, seed=0):
    """The small model with every weight drawn, and LayerNorms and
    BatchNorm's statistics moved off their identity values."""
    gen = torch.Generator().manual_seed(seed)
    model = init_model(ModelConfig(**SMALL, conv_kernel_size=kernel_size), generator=gen)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean") or ("norm" in name and t.dim() == 1):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return model.eval()


def _batch(B=3, T=161, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, 80), generator=gen)
    return x, torch.tensor([T, 118, 37][:B])


@pytest.mark.parametrize("kernel_size", [4, 3])
def test_port_matches_the_plain_reference(kernel_size):
    model = _model(kernel_size)
    x, lens = _batch()
    with torch.no_grad():
        got = model(x, lens)
    want = ref_conformer_l.forward(model.state_dict(), dict(SMALL, conv_kernel_size=kernel_size),
                                   x, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _espnet_rel_shift(x):
    """ESPnet's RelPositionMultiHeadedAttention.rel_shift, written out:
    zero column in front, view as (2T, T), drop the first row, view back,
    keep the first T columns."""
    zero_pad = torch.zeros((*x.size()[:3], 1), dtype=x.dtype)
    x_padded = torch.cat([zero_pad, x], dim=-1)
    x_padded = x_padded.view(*x.size()[:2], x.size(3) + 1, x.size(2))
    return x_padded[:, :, 1:].view_as(x)[:, :, :, : x.size(-1) // 2 + 1]


@pytest.mark.parametrize("T", [1, 5, 16])
def test_plain_op_is_the_espnet_rel_shift(T):
    """The op's plain version pins p's order (distances T-1 down to
    -(T-1)) and the i - j convention to ESPnet's."""
    gen = torch.Generator().manual_seed(T)
    B, H, D = 2, 3, 8
    q, k, v = (torch.randn((B, T, H, D), generator=gen) for _ in range(3))
    p = torch.randn((2 * T - 1, H, D), generator=gen)
    u, w = torch.randn((H, D), generator=gen), torch.randn((H, D), generator=gen)
    lengths = torch.tensor([T, max(T - 2, 1)])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    ac = (qh + u[None, :, None]) @ kh.transpose(-1, -2)
    bd = _espnet_rel_shift((qh + w[None, :, None]) @ p.permute(1, 2, 0))
    mask = torch.arange(T)[None, :] < lengths[:, None]
    scores = (ac + bd) / D ** 0.5 + (mask.float()[:, None, None, :] - 1.0) * 1e9
    want = (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2)
    got = relpos_attention_ref(q, k, v, p, u, w, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    before = tracing.counters()["flash_attention_relpos_fwd"]
    torch.testing.assert_close(rp.relpos_attention(q, k, v, p, u, w, lengths), got,
                               rtol=0, atol=0)
    assert tracing.counters()["flash_attention_relpos_fwd"] == before  # no kernel on the CPU


def test_a_files_logits_do_not_depend_on_its_bucket_or_batch():
    model = _model(4)
    x, lens = _batch()
    n = int(lens[1])
    with torch.no_grad():
        batched = model(x, lens)
        alone = model(x[1:2, :n], lens[1:2])
        longer = model(torch.cat([x, torch.randn((3, 40, 80))], dim=1), lens)
    valid = n // 4
    torch.testing.assert_close(alone[0, :valid], batched[1, :valid], rtol=0, atol=1e-4)
    torch.testing.assert_close(longer[1, :valid], batched[1, :valid], rtol=0, atol=1e-4)


def test_gradients_reach_the_weights_on_the_cpu_and_training_is_refused():
    model = _model(4)
    x, lens = _batch(B=2)
    model(x, lens).sum().backward()
    assert model.blocks[0].attn.pos_bias_u.grad.abs().sum() > 0
    with pytest.raises(NotImplementedError, match="training"):
        model(x, lens, train=True)


def test_the_block_refuses_only_another_dtype_than_bf16_on_the_card():
    """What ``ASRInference`` asks before it serves: the relative-position
    kernel takes bf16, so fp32 is refused on CUDA alone, with the block named."""
    refusal = ConformerCTC(ModelConfig(**SMALL)).block_type.serving_refusal
    assert refusal(torch.float32, torch.device("cpu")) is None
    assert refusal(torch.bfloat16, torch.device("cuda")) is None
    assert "Conformer (L)" in refusal(torch.float32, torch.device("cuda"))
    assert "bfloat16 only" in refusal(torch.float32, torch.device("cuda"))


def test_counts_the_published_size():
    cfg = ModelConfig(n_mels=80, d_model=512, n_heads=8, n_blocks=17, n_classes=1000,
                      conv_kernel_size=32, block="conformer")
    with torch.device("meta"):
        assert count_params(ConformerCTC(cfg)) == 115_633_128


def _save(sd, path):
    torch.save({"model_state_dict": sd, "config": {"n_heads": 2, "n_mel_channels": 80}}, path)
    return str(path)


def test_load_pt_picks_the_block_from_the_keys(tmp_path):
    """A Conformer (L) checkpoint loads with no flag (its heads from
    pos_bias_u, not the stored or default n_heads); a flagship one keeps
    loading as before."""
    model = _model(4)
    cfg, loaded = load_pt(_save(model.state_dict(), tmp_path / "c.pt"), "cpu")
    assert (cfg.block, cfg.n_heads, cfg.conv_kernel_size, cfg.ff_mult, cfg.use_mqa) == (
        "conformer", 4, 4, 4, False)
    x, lens = _batch(B=2)
    with torch.no_grad():
        torch.testing.assert_close(loaded(x, lens), model(x, lens), rtol=0, atol=0)
    flagship = init_model(ModelConfig(n_mels=80, d_model=64, n_heads=2, n_blocks=2,
                                      n_classes=56))
    cfg, _ = load_pt(_save(flagship.state_dict(), tmp_path / "f.pt"), "cpu", n_heads=2)
    assert cfg == ModelConfig(n_mels=80, d_model=64, n_heads=2, n_blocks=2, n_classes=56,
                              dropout=0.0)


def test_asr_inference_serves_the_block(tmp_path):
    model = _model(4)
    path = _save(model.state_dict(), tmp_path / "c.pt")
    rng = np.random.default_rng(0)
    waves = []
    for i, seconds in enumerate((1.5, 3.0)):
        pcm = (rng.standard_normal(int(16000 * seconds)) * 3000).astype("<i2")
        wav = tmp_path / f"a{i}.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        waves.append(str(wav))
    asr = ASRInference(path, device="cpu", compute_dtype=torch.float32, data_parallel=False)
    assert asr.cfg.block == "conformer"
    texts = asr.transcribe_files(waves, batch_size=2)
    assert texts == [asr.transcribe(w) for w in waves]


def test_the_benchmarks_reference_is_the_repos():
    model = _model(4)
    x, lens = _batch()
    cfg = dict(SMALL, conv_kernel_size=4)
    sd = model.state_dict()
    with torch.no_grad():
        got = bench_reference.Reference(sd, cfg).forward(x, lens)
    torch.testing.assert_close(got, ref_conformer_l.forward(sd, cfg, x, lens), rtol=0,
                               atol=1e-5)
