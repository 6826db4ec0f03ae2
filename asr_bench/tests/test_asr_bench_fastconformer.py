"""FastConformer XXL's pieces of the harness on the CPU: its weights layout
against the port's model, its reference against the port in fp32 (a file
past 32 s whole at its long bucket), its frozen counts against their
formulas, its long bucket rule against the program's, its pieces found by
name, and runs of its cell at a tiny size."""

import numpy as np
import pytest
import torch

from asr_bench import (common, fastconformer_counts, fastconformer_weights, faults, relpos_counts,
                        run, traffic)
from asr_bench.reference import fastconformer_xxl

WORKLOAD = "fastconformer_xxl.longform_180_240s"
CFG = common.load_json("configs", "fastconformer_xxl")
TINY = dict(CFG, d_model=64, n_heads=4, n_blocks=2, subsample_channels=8)
SR = 16000


def port_model(cfg, sd):
    from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig
    model = ConformerCTC(ModelConfig(
        n_mels=cfg["n_mels"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_blocks=cfg["n_blocks"], n_classes=cfg["n_classes"], ff_mult=cfg["ff_mult"],
        conv_kernel_size=cfg["conv_kernel_size"], block=cfg["block"],
        subsample=cfg["subsample"], subsample_channels=cfg["subsample_channels"]))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_weights_load_strictly_into_the_port_and_count_params():
    from turkish_asr_torch.models.conformer import count_params
    assert fastconformer_weights.param_count(CFG) == CFG["params"] == 1_062_540_289
    one = dict(TINY, n_blocks=1)
    sd = fastconformer_weights.make_state_dict(one, 3, "cpu", served=True)
    model = port_model(one, sd)
    assert count_params(model) == fastconformer_weights.param_count(one)
    assert sd["blocks.0.attn.pos_bias_u"].abs().max() <= 1 / 4
    assert tuple(sd["subsample.2.weight"].shape) == (8, 1, 3, 3)
    assert tuple(sd["input_proj.weight"].shape) == (64, 8 * 10)


def test_the_references_logits_match_the_port_in_fp32():
    """A 3 s file at its 4 s bucket and a 40 s one whole at 64 s."""
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    sd = fastconformer_weights.make_state_dict(TINY, 5, "cpu", served=True)
    rng = traffic.rng_of(2, 1)
    waves = [traffic.samples(n, rng).astype(np.float32) / 32768.0 for n in (48000, 640000)]
    mine = fastconformer_xxl.logits_of(sd, TINY, waves, "fp32")
    model = port_model(TINY, sd)
    for w, ref in zip(waves, mine):
        S = fastconformer_xxl.long_bucket(len(w))
        padded = np.zeros((1, S), np.float32)
        padded[0, :len(w)] = w
        feats, frames = log_mel_spectrogram(torch.from_numpy(padded), torch.tensor([len(w)]))
        with torch.no_grad():
            port = model(feats, frames, torch.float32)
        n = int(fastconformer_xxl.frames(int(frames[0])))
        assert ref.shape == (n, 1025)
        torch.testing.assert_close(ref, port[0, :n], rtol=0, atol=1e-4)


def test_the_long_bucket_rule_is_the_programs():
    from turkish_asr_torch.data.buckets import bucket_table
    from turkish_asr_torch.inference import whole_file_buckets
    program = whole_file_buckets(256)
    for n in (1, 16000, 512000, 512001, 180 * SR, 192 * SR, 192 * SR + 1, 240 * SR, 256 * SR):
        assert fastconformer_xxl.long_bucket(n, 256) == bucket_table(n, program), n
    mix = common.load_json("traffic", "longform_180_240s")
    got = {fastconformer_xxl.long_bucket(n, mix["full_context_s"]) // SR
           for n in traffic.lengths(mix["clip_seconds"], mix["pool"], traffic.rng_of(7, 1))}
    assert got == {192, 224, 256}


def _flops(seconds, d=1024, L=42, k=9, V=1025, C=256):
    """The forward's count written out for the configuration's sizes."""
    T = int(1 + seconds * 100)
    t = [T]
    for _ in range(3):
        t.append((t[-1] + 1) // 2)
    T8, f = t[3], [40, 20, 10]
    front = 2 * T * 400 * 402 + 2 * T * 201 * 80
    sub = (2 * t[1] * f[0] * 9 * C + 2 * t[2] * f[1] * (9 * C + C * C)
           + 2 * T8 * f[2] * (9 * C + C * C) + 2 * T8 * f[2] * C * d)
    block = (2 * (4 * T8 * d * 4 * d) + 8 * T8 * d * d + 6 * T8 * T8 * d
             + 4 * T8 * d * d + 2 * T8 * k * d + 2 * T8 * d * d)
    return front + sub + L * block + 2 * T8 * d * V


@pytest.mark.parametrize("seconds", [256.0, 210.5, 180.0])
def test_forward_flops_is_its_formula(seconds):
    got = fastconformer_counts.forward_flops(common.ModelConfig(CFG), seconds)
    assert got == _flops(seconds)
    if seconds == 256.0:  # about 36 GFLOP a padded audio second
        assert 9.1e12 < got < 9.3e12


def test_kernel_bounds_at_head_size_128():
    """The bound ``attn_relpos_roofline.conformer_l`` reads at this cell's
    calls, which its spans give D = 128."""
    got = relpos_counts.kernel_bounds(4, 8, 3201, 128, "bf16")
    assert got["flops"] == 6 * 4 * 8 * 3201 * 3201 * 128 and got["bound_by"] == "operations"


def test_every_new_piece_is_found_by_name():
    bench = common.benchmark()
    entry, config = common.cell_of(bench, WORKLOAD)
    assert (entry["chips"], config["reduced"], config["file"]) == (
        1, [], "asr_bench/configs/fastconformer_xxl.json")
    mix = common.load_json("traffic", entry["traffic"])
    assert mix["driver"] == "transcribe_long" and mix["batch_size"] == 4
    assert (mix["pool"], mix["paths_per_call"], mix["check_files"], mix["full_context_s"]) == (
        96, 48, 12, 256)
    driver = common.load_module("drivers", mix["driver"])
    assert driver._by_config.module_of(CFG, "weights") is fastconformer_weights
    assert driver._by_config.module_of(CFG, "reference") is fastconformer_xxl
    for check in ("text_gap", "logit_err"):
        limits = common.load_json("limits", WORKLOAD)[check]
        assert limits["lower"] < limits["limit"] < limits["upper"]
    names = [m["name"] for m in common.metrics_of(bench, WORKLOAD, "per_layer")]
    assert names == ["device_idle_share.transcribe", "load_ms_per_audio_s.transcribe",
                     "idle_in_load_share.transcribe", "idle_in_forward_share.transcribe",
                     "decode_wait_ms.transcribe", "padding_share_counted.transcribe",
                     "attn_relpos_roofline.conformer_l", "nongemm_share.conformer_l",
                     "subsample_share.fastconformer_xxl", "mfu.fastconformer_xxl"]
    assert [m["name"] for m in common.metrics_of(bench, WORKLOAD, "end_to_end")] == [
        "transcribe_audio_s_per_s", "setup_s"]
    for name in names:
        assert common.load_module("metrics", name).read(_Empty()) is None


class _Empty:
    """A traced run's context with nothing to read."""
    trace = None
    peak_flops = None
    stats = {}


def tiny_cell(seed=1):
    mix = dict(common.load_json("traffic", "longform_180_240s"), pool=3, paths_per_call=3,
               batch_size=2, check_files=2, full_context_s=64,
               clip_seconds={"dist": "uniform", "min": 33.0, "max": 36.0})
    return run.Cell(WORKLOAD, 1, TINY, mix, seed, 0.5, device="cpu")


def test_a_tiny_run_is_correct_whole_and_an_altered_token_is_not():
    from turkish_asr_torch.utils import tracing
    bench = common.benchmark()
    limits = common.load_json("limits", WORKLOAD)
    chunked = tracing.counters()["chunked_files"]
    out = run.execute(tiny_cell(), bench)
    checks = {name: value for name, value, _ in out[5]}
    assert out[0] and checks["text_gap"] < limits["text_gap"]["limit"], out[5]
    assert checks["logit_err"] < limits["logit_err"]["limit"], out[5]
    assert tracing.counters()["chunked_files"] == chunked  # every file ran whole
    cell = tiny_cell()
    cell.fault = faults.altered_token
    out = run.execute(cell, bench)
    assert not out[0] and out[5][0][1] > limits["text_gap"]["limit"]


def test_a_tiny_fp8_control_fails_logit_err():
    limit = common.load_json("limits", WORKLOAD)["logit_err"]["limit"]
    out = run.execute(tiny_cell(2), common.benchmark(), controls=("fp8",))
    checks = {name: value for name, value, _ in out[5]}
    control = {name: value for name, value, _ in out[7]["fp8"]}
    assert checks["logit_err"] < limit < control["logit_err"], (out[5], out[7])


def test_a_program_without_full_context_fails_at_once(monkeypatch):
    """An ``ASRInference`` that takes no ``full_context_s`` (a program older
    than the whole-file buckets): the driver refuses before it writes
    anything."""
    import turkish_asr_torch.inference as inference

    class Older:
        def __init__(self, model_path, n_heads=4, device="cuda"):
            raise AssertionError("not reached")

    monkeypatch.setattr(inference, "ASRInference", Older)
    cell = tiny_cell()
    driver = common.load_module("drivers", "transcribe_long").Driver(cell)
    with pytest.raises(RuntimeError, match="full_context_s"):
        driver.setup()
    assert not hasattr(driver, "tmp")
