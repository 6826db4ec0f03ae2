"""Conformer (L)'s pieces of the harness on the CPU: its weights layout
against the port's model, its frozen counts against their formulas, its
pieces found by name, its check's ``logit_err``, and runs of its cell at a
tiny size."""

import math

import numpy as np
import pytest
import torch

from asr_bench import common, faults, relpos_counts, relpos_weights, run, traffic
from asr_bench.reference import conformer_l

WORKLOAD = "conformer_l.transcribe_24_32s"
CFG = common.load_json("configs", "conformer_l")
TINY = dict(CFG, d_model=64, n_heads=4, n_blocks=2, conv_kernel_size=4)


def port_model(cfg, sd):
    from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig
    model = ConformerCTC(ModelConfig(
        n_mels=cfg["n_mels"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_blocks=cfg["n_blocks"], n_classes=cfg["n_classes"], ff_mult=cfg["ff_mult"],
        conv_kernel_size=cfg["conv_kernel_size"], block=cfg["block"]))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_weights_load_strictly_into_the_port_and_count_params():
    from turkish_asr_torch.models.conformer import count_params
    assert relpos_weights.param_count(CFG) == CFG["params"] == 115_633_128
    one = dict(CFG, n_blocks=1)
    sd = relpos_weights.make_state_dict(one, 3, "cpu", served=True)
    model = port_model(one, sd)
    assert count_params(model) == relpos_weights.param_count(one)
    assert torch.equal(sd["fc.weight"],
                       relpos_weights.make_state_dict(one, 3, "cpu", served=True)["fc.weight"])
    assert sd["blocks.0.attn.pos_bias_u"].abs().max() <= 1 / 8
    assert "blocks.0.attn.linear_pos.bias" not in sd


def test_the_references_logits_match_the_port_in_fp32():
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    sd = relpos_weights.make_state_dict(TINY, 5, "cpu", served=True)
    rng = traffic.rng_of(2, 1)
    waves = [traffic.samples(n, rng).astype(np.float32) / 32768.0 for n in (20000, 26000)]
    S = conformer_l.bucket(26000)
    mine = conformer_l.logits_of(sd, TINY, waves, "fp32")
    padded = np.zeros((2, S), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    feats, frames = log_mel_spectrogram(torch.from_numpy(padded),
                                        torch.tensor([len(w) for w in waves]))
    with torch.no_grad():
        port = port_model(TINY, sd)(feats, frames, torch.float32)
    for i in range(2):
        n = int(frames[i]) // 4
        torch.testing.assert_close(mine[i], port[i, :n], rtol=0, atol=2e-3)


def _flops(seconds, d=512, L=17, k=32, V=1000, F=80):
    """The forward's count written out for the configuration's sizes."""
    T = int(1 + seconds * 100)
    T2, T4, F2, F4 = math.ceil(T / 2), math.ceil(math.ceil(T / 2) / 2), 40, 20
    front = 2 * T * 400 * 402 + 2 * T * 201 * F
    sub = 2 * T2 * F2 * 9 * d + 2 * T4 * F4 * 9 * d * d + 2 * T4 * F4 * d * d
    block = (2 * (4 * T4 * d * 4 * d) + 8 * T4 * d * d + 6 * T4 * T4 * d
             + 4 * T4 * d * d + 2 * T4 * k * d + 2 * T4 * d * d)
    return front + sub + L * block + 2 * T4 * d * V


@pytest.mark.parametrize("seconds", [32.0, 24.5])
def test_forward_flops_is_its_formula(seconds):
    got = relpos_counts.forward_flops(common.ModelConfig(CFG), seconds)
    assert got == _flops(seconds)
    if seconds == 32.0:  # about 284 GFLOP a padded 32 s row
        assert 2.83e11 < got < 2.85e11


@pytest.mark.parametrize("B,H,T,D", [(32, 8, 801, 64), (1, 8, 1601, 64)])
def test_kernel_bounds_are_their_formula(B, H, T, D):
    got = relpos_counts.kernel_bounds(B, H, T, D, "bf16")
    assert got["flops"] == 6 * B * H * T * T * D
    assert got["bytes"] == 4 * B * T * H * D * 2 + H * (2 * T - 1) * D * 2 + 2 * H * D * 4
    assert got["bound_ms"] == pytest.approx(1e3 * max(got["flops"] / 989e12,
                                                      got["bytes"] / 3.35e12))
    assert got["bound_by"] == "operations"


def test_every_new_piece_is_found_by_name():
    bench = common.benchmark()
    entry, config = common.cell_of(bench, WORKLOAD)
    assert (entry["chips"], config["reduced"], config["file"]) == (
        1, [], "asr_bench/configs/conformer_l.json")
    mix = common.load_json("traffic", entry["traffic"])
    assert mix["driver"] == "transcribe_by_config" and mix["batch_size"] == 32
    driver = common.load_module("drivers", mix["driver"])
    assert driver.module_of(CFG, "weights") is relpos_weights
    assert driver.module_of(CFG, "reference") is conformer_l
    for check in ("text_gap", "logit_err"):
        limits = common.load_json("limits", WORKLOAD)[check]
        assert limits["lower"] < limits["limit"] < limits["upper"]
    names = [m["name"] for m in common.metrics_of(bench, WORKLOAD, "per_layer")]
    assert names == ["padding_share.transcribe", "device_idle_share.transcribe",
                     "load_ms_per_audio_s.transcribe", "idle_in_load_share.transcribe",
                     "idle_in_forward_share.transcribe", "decode_wait_ms.transcribe",
                     "padding_share_counted.transcribe", "attn_relpos_roofline.conformer_l",
                     "mfu.conformer_l", "nongemm_share.conformer_l"]
    for name in names:
        assert common.load_module("metrics", name).read(_Empty()) is None
    flagship = common.load_module("drivers", "transcribe")
    assert flagship.write_checkpoint.__module__ == "asr_bench.served"  # left as it was


class _Empty:
    """A traced run's context with nothing to read."""
    trace = None
    peak_flops = None
    stats = {}


def tiny_cell(seed=1):
    mix = dict(common.load_json("traffic", "transcribe_24_32s"), pool=6, paths_per_call=4,
               batch_size=2, check_files=3, clip_seconds={"dist": "uniform", "min": 1.5,
                                                         "max": 3.0})
    return run.Cell(WORKLOAD, 1, TINY, mix, seed, 1.0, device="cpu")


def test_logit_err_reads_the_logits_error_as_a_share_of_their_spread():
    driver = common.load_module("drivers", "transcribe_by_config")
    g = torch.Generator().manual_seed(4)
    ref, noise = (torch.randn(50, 30, generator=g, dtype=torch.float64) for _ in range(2))
    assert driver.logit_err(ref, ref) == 0.0
    # a constant a frame moves no label: it is not error
    assert driver.logit_err(ref + torch.randn(50, 1, generator=g, dtype=torch.float64),
                            ref) < 1e-12
    centred = ref - ref.mean(-1, keepdim=True)
    err = (noise - noise.mean(-1, keepdim=True)).pow(2).mean().sqrt() / centred.pow(2).mean().sqrt()
    assert driver.logit_err(ref + 0.1 * noise, ref) == pytest.approx(0.1 * float(err))
    # a share: the logits' scale cancels
    assert driver.logit_err(3 * ref + 0.3 * noise, 3 * ref) == pytest.approx(
        driver.logit_err(ref + 0.1 * noise, ref))


def test_a_tiny_run_is_correct_and_an_altered_token_is_not():
    bench = common.benchmark()
    limits = common.load_json("limits", WORKLOAD)
    out = run.execute(tiny_cell(), bench)
    checks = {name: value for name, value, _ in out[5]}
    assert out[0] and checks["text_gap"] < limits["text_gap"]["limit"], out[5]
    assert checks["logit_err"] < limits["logit_err"]["limit"], out[5]
    cell = tiny_cell()
    cell.fault = faults.altered_token
    out = run.execute(cell, bench)
    assert not out[0] and out[5][0][1] > limits["text_gap"]["limit"]


def test_a_tiny_fp8_control_fails_logit_err():
    """The reference with fp8 operands in the program's place: its logits'
    error is read, as on the card, far past the limit."""
    limit = common.load_json("limits", WORKLOAD)["logit_err"]["limit"]
    out = run.execute(tiny_cell(2), common.benchmark(), controls=("fp8",))
    checks = {name: value for name, value, _ in out[5]}
    control = {name: value for name, value, _ in out[7]["fp8"]}
    assert checks["logit_err"] < limit < control["logit_err"], (out[5], out[7])
