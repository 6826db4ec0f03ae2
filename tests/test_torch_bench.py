"""The port's bench (turkish_asr_torch/bench.py) against bench.py, on the CPU.

Tiny configurations, passed as arguments or set by monkeypatch; the
JAX side runs its einsum attention core (``attn_kernel=None``), the plain
reference its own tests use on the CPU. Tolerances:

- ``model_forward_flops``, ``_waves``, the synthetic ARPA's bytes, the
  flagship configuration and config 2's wer/cer on the same ids: exact.
- the greedy pipeline in fp32 on the JAX weights (carried by
  ``utils/weights.py``): logits within 1e-4 absolute, as
  tests/test_torch_model.py holds the model; ids and counts equal. The
  trie beam pipeline: ids and counts equal.
- the kernel-off core on the CPU: the default's logits bit for bit (both
  are the plain version there), its training gradients within 1e-5 of the
  largest (autograd through the plain forward against the analytic plain
  backward), and the JAX ``attn_kernel=None`` logits within 1e-4.
"""

import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as jax_bench  # noqa: E402
from __graft_entry__ import _flagship_cfg as jax_flagship_cfg  # noqa: E402
from turkish_asr_torch import bench as port_bench  # noqa: E402
from turkish_asr_torch.scripts.synthetic_arpa import synthetic_token_arpa  # noqa: E402

TINY = dict(d_model=32, n_heads=2, n_blocks=2)
CONFORMER_L = dict(d_model=512, n_heads=8, n_blocks=16)  # bench.py:460 and :611


def _jax_model(kw):
    from turkish_asr_tpu.models.conformer import init_model
    from turkish_asr_torch.utils.weights import state_dict_from_jax
    jcfg = jax_flagship_cfg(**kw)
    params, state = init_model(jax.random.PRNGKey(0), jcfg)
    cfg = port_bench._flagship_cfg(**kw)
    model = port_bench._model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, state), cfg.n_heads),
                          strict=True)
    return jcfg, (params, state), cfg, model


@pytest.fixture
def jax_fp32(monkeypatch):
    """bench.py's pipelines with the model in fp32 (they hard-code bf16)."""
    import turkish_asr_tpu.models.conformer as jconf
    real = jconf.apply_model
    monkeypatch.setattr(jconf, "apply_model",
                        lambda *a, **kw: real(*a, **{**kw, "compute_dtype": jnp.float32}))


@pytest.mark.parametrize("seconds", [1.0, 8.0, 64.0])
@pytest.mark.parametrize("kw", [{}, CONFORMER_L], ids=["flagship", "conformer_l"])
def test_model_forward_flops_equals_bench_py(kw, seconds):
    assert (port_bench.model_forward_flops(port_bench._flagship_cfg(**kw), seconds)
            == jax_bench.model_forward_flops(jax_flagship_cfg(**kw), seconds))


def test_configurations_are_bench_pys():
    for kw in ({}, CONFORMER_L):
        want, got = jax_flagship_cfg(**kw), port_bench._flagship_cfg(**kw)
        for name in ("n_mels", "d_model", "n_heads", "n_blocks", "n_classes", "dropout",
                     "conv_kernel_size", "use_mqa", "ff_mult", "masked_norm"):
            assert getattr(got, name) == getattr(want, name), name
    assert port_bench.CONFORMER_L == CONFORMER_L
    assert (port_bench.BATCH, port_bench.SECONDS, port_bench.ITERS, port_bench.SR) == (
        jax_bench.BATCH, jax_bench.SECONDS, jax_bench.ITERS, jax_bench.SR)
    assert port_bench.LONGFORM == (16, 64.0) and port_bench.LONGFORM_TRAIN == (4, 64.0)


def test_waves_equal_bench_pys():
    w, n = port_bench._waves(3, 0.5, seed=4)
    jw, jn = jax_bench._waves(3, 0.5, seed=4)
    assert w.dtype == torch.float32 and n.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_synthetic_token_arpa_writes_bench_pys_bytes(tmp_path):
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer as JaxTok
    from turkish_asr_torch.data.tokenizer import TurkishTokenizer
    synthetic_token_arpa(TurkishTokenizer(), tmp_path / "port.arpa")
    jax_bench._synthetic_arpa(JaxTok(), str(tmp_path / "jax.arpa"))
    assert (tmp_path / "port.arpa").read_bytes() == (tmp_path / "jax.arpa").read_bytes()


def test_greedy_pipeline_matches_bench_py_in_fp32(jax_fp32):
    from turkish_asr_tpu.audio.features import log_mel_spectrogram
    from turkish_asr_tpu.models.conformer import apply_model
    jcfg, pstate, cfg, model = _jax_model(TINY)
    w, n = port_bench._waves(3, 1.0, seed=2)
    jw, jn = jax_bench._waves(3, 1.0, seed=2)
    want_ids, want_counts = jax_bench._make_pipeline(jcfg, None)(pstate, jw, jn)
    feats, fl = log_mel_spectrogram(jw, jn, n_mels=jcfg.n_mels)
    want_logits, _ = apply_model(*pstate, feats, fl, cfg=jcfg, train=False,
                                 compute_dtype=jnp.float32)
    with torch.inference_mode():
        ids, counts = port_bench._make_pipeline(cfg, model, compute_dtype=torch.float32)(w, n)
        logits, out_lengths = port_bench._logits(cfg, model, w, n, torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4)
    np.testing.assert_array_equal(out_lengths.numpy(), np.asarray(fl) // 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(counts.sum()) > 0


def test_trie_beam_pipeline_matches_bench_py_in_fp32(jax_fp32, tmp_path):
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer as JaxTok
    from turkish_asr_tpu.decode import lm as jax_lm
    from turkish_asr_torch.data.tokenizer import TurkishTokenizer
    from turkish_asr_torch.decode import lm as port_lm
    from turkish_asr_torch.scripts.synthetic_arpa import synthetic_word_arpa
    jcfg, pstate, cfg, model = _jax_model(TINY)
    arpa = str(tmp_path / "words.arpa")
    synthetic_word_arpa(arpa)
    jtrie = jax_lm.build_trie_fusion_tables(jax_lm.ArpaLanguageModel(arpa), JaxTok(),
                                            jcfg.n_classes)
    jtrie = {k: (jnp.asarray(v) if hasattr(v, "shape") else v) for k, v in jtrie.items()}
    jw, jn = jax_bench._waves(2, 1.0, seed=3)
    want_ids, want_counts = jax_bench._make_pipeline(
        jcfg, None, decode="beam", lm_trie=jtrie, beam_width=16)(pstate, jw, jn)

    trie = port_lm.build_trie_fusion_tables(port_lm.ArpaLanguageModel(arpa), TurkishTokenizer(),
                                            cfg.n_classes)
    w, n = port_bench._waves(2, 1.0, seed=3)
    pipeline = port_bench._make_pipeline(
        cfg, model, decode="beam", compute_dtype=torch.float32,
        lm_kwargs=port_bench._lm_kwargs("cpu", trie["start_h"], lm_trie=trie))
    with torch.inference_mode():
        ids, counts = pipeline(w, n)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("augment", [False, True], ids=["config2", "config3"])
def test_train_step_ms_returns_the_triple(augment):
    sec, eval_sec, eval_metrics = port_bench._train_step_ms(
        2, augment=augment, accumulation_steps=2 if augment else 1, n_steps=1,
        cfg=port_bench._flagship_cfg(**TINY), seconds=0.5, device="cpu")
    assert sec > 0
    if augment:
        assert eval_sec is None and eval_metrics is None
    else:
        assert eval_sec > 0 and set(eval_metrics) == {"wer", "cer"}
        assert 0.0 <= eval_metrics["cer"] and 0.0 <= eval_metrics["wer"]


def test_eval_metrics_equal_bench_pys_scoring():
    """Config 2's wer/cer: the port's scoring of eval ids against
    bench.py's (trainer.metrics.compute_from_ids, rounded to 4 places) on
    the same ids, counts and targets."""
    from turkish_asr_tpu.data.tokenizer import TurkishTokenizer as JaxTok
    from turkish_asr_tpu.utils.metrics import ASRMetrics as JaxMetrics
    from turkish_asr_torch.data.tokenizer import TurkishTokenizer
    from turkish_asr_torch.utils.metrics import ASRMetrics
    rng = np.random.default_rng(5)
    targets = rng.integers(2, 55, (4, 64)).astype(np.int32)
    ids = np.full((4, 100), -1, np.int32)
    counts = np.asarray([64, 40, 70, 0], np.int32)
    ids[0, :64] = targets[0]                       # exact
    ids[1, :40] = targets[1, :40]                  # deletions
    ids[2, :70] = rng.integers(2, 55, 70)          # noise
    got = port_bench._eval_metrics(ASRMetrics(TurkishTokenizer()), torch.from_numpy(ids),
                                   torch.from_numpy(counts), targets)
    result, _, _ = JaxMetrics(JaxTok()).compute_from_ids(ids, counts, targets)
    assert got == {"wer": round(float(result["wer"]), 4), "cer": round(float(result["cer"]), 4)}
    assert 0.0 < got["cer"] < 1.0


def test_train_step_ms_call_sites_unpack_full_return():
    """Every ``_train_step_ms`` call site unpacks as many values as it
    returns (tests/test_bench_smoke.py's check, for bench.py's round-5
    bug: a third return value its callers did not unpack)."""
    tree = ast.parse(open(port_bench.__file__).read())
    n_returns = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_train_step_ms":
            rets = [r for r in ast.walk(node) if isinstance(r, ast.Return) and r.value is not None]
            assert rets, "no return statements found"
            for r in rets:
                assert isinstance(r.value, ast.Tuple), ast.dump(r.value)
                assert n_returns in (None, len(r.value.elts)), "inconsistent return arity"
                n_returns = len(r.value.elts)
    assert n_returns == 3
    checked = 0
    for node in ast.walk(tree):
        call = getattr(node, "value", None)
        if isinstance(call, ast.Call) and isinstance(call.func, ast.Name) \
                and call.func.id == "_train_step_ms":
            assert isinstance(node, ast.Assign), f"line {node.lineno}: result not unpacked"
            target = node.targets[0]
            assert isinstance(target, ast.Tuple) and len(target.elts) == n_returns, (
                f"line {node.lineno}: _train_step_ms returns {n_returns} values")
            checked += 1
    assert checked >= 4, f"expected >= 4 call sites (configs 2, 3, 5 on and off), found {checked}"


def test_fields_are_bench_pys():
    """bench.FIELDS names the fields of bench.py's lines in BENCH_r05.json."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    lines = [json.loads(s) for s in tail.splitlines() if s.startswith("{")]
    want = {d["metric"]: tuple(k for k in d if k not in ("metric", "value", "unit"))
            for d in lines}
    assert want == port_bench.FIELDS


def _shrink(monkeypatch):
    real = port_bench._flagship_cfg
    monkeypatch.setattr(port_bench, "_flagship_cfg",
                        lambda n_classes=55, **kw: real(n_classes, **{**TINY, **kw}))
    monkeypatch.setattr(port_bench, "BATCH", 2)
    monkeypatch.setattr(port_bench, "SECONDS", 0.5)
    monkeypatch.setattr(port_bench, "CONFORMER_L", dict(d_model=32, n_heads=2, n_blocks=2))
    monkeypatch.setattr(port_bench, "LONGFORM", (2, 1.0))
    monkeypatch.setattr(port_bench, "LONGFORM_TRAIN", (2, 1.0))
    # The smallest ARPA of this shape build_trie_fusion_tables still refuses.
    monkeypatch.setattr(port_bench, "ARPA_100K",
                        dict(n_words=2000, seed=7, ngram_counts={2: 10000, 3: 6000, 4: 2000}))


def test_main_prints_every_config_with_the_headline_last(monkeypatch, capsys):
    _shrink(monkeypatch)
    monkeypatch.setattr(port_bench, "_cap", lambda n, cap: 1)  # one timed iteration each
    assert port_bench.main(["--device", "cpu"]) == 0
    out = [json.loads(s) for s in capsys.readouterr().out.splitlines()
           if s.startswith('{"metric"')]
    metrics = [d["metric"] for d in out]
    assert metrics == ["rtfx_greedy_single", "train_step_ms_b8", "train_step_ms_b32_aug",
                       "rtfx_beam16_arpa", "rtfx_beam16_arpa_100k", "rtfx_longform_conformer_l",
                       "train_step_ms_conformer_l", "rtfx_greedy_batch"], out
    for d in out:
        assert set(d) == {"metric", "value", "unit", "device", "power_limit_w",
                          *port_bench.FIELDS[d["metric"]]}, d
        assert d["value"] > 0 and d["device"] is None and d["power_limit_w"] is None
        assert "mfu" not in d or d["mfu"] is None  # no peak for the CPU
    assert out[-1]["vs_baseline"] > 0
    assert out[4]["host_peak_rss_gb"] > 0


def test_power_limit_is_the_measured_cards(monkeypatch):
    """On a host with two cards the line's power limit is the one whose
    UUID is the device's, not nvidia-smi's first line; a card nvidia-smi
    does not list gives None."""
    import subprocess
    import types
    smi = "GPU-aaaa, 350.00 W\nGPU-bbbb, 700.00 W\n"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(uuid={1: "bbbb", 2: "cccc"}[dev.index]))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=smi))
    card = port_bench._card.__wrapped__
    assert card("cuda:1") == ("NVIDIA H100 80GB HBM3", 700.0)
    assert card("cuda:2") == ("NVIDIA H100 80GB HBM3", None)


def test_peak_rss_covers_only_its_block():
    """The 100k line's peak RSS is the peak over the ARPA build's block: a
    transient allocation inside it shows, a larger peak from before it
    does not."""
    import time
    with port_bench._peak_rss() as inside:
        big = np.ones(50_000_000)  # 0.4 GB, touched
        time.sleep(0.1)
        del big
    with port_bench._peak_rss() as after:
        pass
    assert inside["gb"] > after["gb"] + 0.3


def test_a_failing_config_prints_its_error_line(monkeypatch, capsys):
    _shrink(monkeypatch)

    def broken(device, cap):
        raise RuntimeError("boom")

    broken.__name__ = "bench_greedy_single"
    monkeypatch.setattr(port_bench, "CONFIGS", (broken,))
    lines = port_bench.run("cpu", 1)
    assert [d["metric"] for d in lines] == ["error_bench_greedy_single", "rtfx_greedy_batch"]
    assert lines[0]["unit"] == "error" and lines[0]["detail"] == "boom"
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert printed == lines


def test_main_needs_cuda_without_a_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main() would run the full bench")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_bench.main([])


def test_cpu_has_no_card_and_no_peak():
    assert port_bench._card("cpu") == (None, None)
    assert port_bench._peak_flops("cpu") == (None, None)
    import chip_smoke
    assert port_bench.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == chip_smoke.PEAK_FLOPS["bf16"]


def test_baseline_is_read_from_the_repo_and_never_written():
    path = os.path.join(ROOT, "baseline_measured.json")
    before = open(path, "rb").read(), os.path.getmtime(path)
    assert port_bench.BASELINE_CACHE == path
    assert port_bench.bench_torch_baseline() == json.loads(before[0])["rtfx_torch_cpu"]
    assert (open(path, "rb").read(), os.path.getmtime(path)) == before


def test_baseline_is_measured_and_not_saved_without_the_cache(monkeypatch, tmp_path):
    """With no cache the stock torch.nn proxy runs (a small batch and clip
    here) and its figure is returned, not written anywhere."""
    missing = tmp_path / "baseline_measured.json"
    monkeypatch.setattr(port_bench, "BASELINE_CACHE", str(missing))
    monkeypatch.setattr(port_bench, "BASELINE_BATCH", 1)
    monkeypatch.setattr(port_bench, "SECONDS", 0.5)
    assert port_bench.bench_torch_baseline() > 0
    assert list(tmp_path.iterdir()) == []


def test_kernel_off_is_the_plain_core_and_matches_jax():
    """``attn_kernel=False`` against the default on the CPU (both the plain
    version there: bit for bit) and against the JAX einsum core."""
    from turkish_asr_tpu.audio.features import log_mel_spectrogram
    from turkish_asr_tpu.models.conformer import apply_model
    jcfg, pstate, cfg, model = _jax_model(TINY)
    w, n = port_bench._waves(2, 1.0, seed=6)
    n[1] = 11000  # a ragged row: padded keys are masked
    jw, jn = jnp.asarray(w.numpy()), jnp.asarray(n.numpy())
    feats, fl = log_mel_spectrogram(jw, jn, n_mels=jcfg.n_mels)
    want, _ = apply_model(*pstate, feats, fl, cfg=jcfg, train=False, compute_dtype=jnp.float32,
                          attn_kernel=None)
    with torch.inference_mode():
        on, _ = port_bench._logits(cfg, model, w, n, torch.float32)
        off, _ = port_bench._logits(cfg, model, w, n, torch.float32, attn_kernel=False)
    assert torch.equal(on, off)
    np.testing.assert_allclose(off.numpy(), np.asarray(want), atol=1e-4)


def test_kernel_off_trains_through_the_same_function():
    """A training step (dropout 0.1 inside the attention core, remat) with
    the kernel-off core: the default's loss bit for bit and its gradients
    within 1e-5 of the largest; the Trainer threads the argument."""
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    cfg = port_bench._flagship_cfg(**TINY)
    model = port_bench._model(cfg, "cpu")
    w, n = port_bench._waves(2, 1.0, seed=8)
    feats, fl = log_mel_spectrogram(w, n, n_mels=cfg.n_mels)
    params = [p for p in model.parameters() if p.requires_grad]
    losses, grads = [], []
    for kernel in (True, False):
        logits, _ = model(feats, fl, torch.float32, train=True, seed=9, remat="full",
                          attn_kernel=kernel)
        loss = logits.square().mean()
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    assert torch.equal(losses[0], losses[1])
    scale = max(g.abs().max().item() for g in grads[0] if g is not None)
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a - b).abs().max().item() <= 1e-5 * scale

    seen = []
    real = model.forward
    model.forward = lambda *a, **kw: seen.append(kw.get("attn_kernel")) or real(*a, **kw)
    from turkish_asr_torch.train.optim import make_optimizer
    from turkish_asr_torch.train.trainer import Trainer
    from turkish_asr_torch.utils.config import get_config
    from turkish_asr_torch.utils.logger import get_logger
    optimizer, schedule = make_optimizer(params, 5e-4, 1e-6, 1000)
    trainer = Trainer(model, optimizer, schedule, get_config([]), get_logger("t", None),
                      device="cpu", compute_dtype=torch.float32, attn_kernel=False)
    batch = {"waveforms": w.numpy(), "wav_lengths": n.numpy(),
             "targets": np.full((2, 3), 5, np.int32), "target_lengths": np.full(2, 3, np.int32),
             "sample_mask": np.ones(2, np.float32)}
    trainer.train_step(batch, 0)
    trainer._loss(trainer._to_device(batch), False)
    assert seen == [False, False]
