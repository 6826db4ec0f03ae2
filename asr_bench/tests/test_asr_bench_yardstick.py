"""The yardstick on the CPU: traffic from the seed, the frozen copies at
the values PERF.md cites, and what the harness imports."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from asr_bench import common, frozen, traffic
from asr_bench.reference.bpe import Vocabulary

HERE = common.HERE


def mix(name):
    return common.load_json("traffic", name)


@pytest.mark.parametrize("name", ["transcribe_16_32s"])
def test_same_seed_same_traffic(name):
    m = dict(mix(name), pool=16)
    a, b = traffic.clip_pool(m, 2 ** 31 + 7), traffic.clip_pool(m, 2 ** 31 + 7)
    c = traffic.clip_pool(m, 2 ** 31 + 8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a, c))
    # every seed gets the same set of lengths, in another order
    assert sorted(map(len, a)) == sorted(map(len, c))
    lo, hi = m["clip_seconds"]["min"], m["clip_seconds"]["max"]
    assert all(lo * 16000 <= len(x) <= hi * 16000 for x in a)


def test_choices_from_the_seed():
    picks = traffic.choices(10, 25, 5)
    assert picks == traffic.choices(10, 25, 5) and sorted(picks[:10]) == list(range(10))


def test_transcripts_spell_with_the_tokenizer():
    vocab = Vocabulary.of(common.load_json("configs", "flagship"))
    rng = traffic.rng_of(3, 4)
    for n in (16000, 80000, 160000):
        text = traffic.transcript(n, 12, rng)
        assert 1 not in vocab.encode(text) and vocab.decode(vocab.encode(text)) == text
        assert abs(len(text) - 12 * n / 16000) <= 1


def test_wav_round_trip():
    from asr_bench.reference.conformer_ctc import decode_wav
    pcm = traffic.samples(1234, traffic.rng_of(1, 1))
    assert np.array_equal(decode_wav(traffic.wav_bytes(pcm)), pcm.astype(np.float32) / 32768.0)


def test_frozen_copies_at_the_cited_values():
    """PERF.md's kernel table: bounds 0.0035 ms (attention forward,
    training, bytes), 0.0060 (served, operations), 0.0849 (config 5,
    B=16 T'=1601 H=8), CTC 0.0014 / 0.0018 (bytes), SwiGLU 0.0102 and
    C=512 0.0407; the bf16 peak of the H100 SXM."""
    kb = frozen.kernel_bounds
    attn = dict(H=4, Kh=1, D=64)
    assert round(kb("flash_attention_fwd", B=32, T=200, **attn)["bound_ms"], 4) == 0.0035
    assert kb("flash_attention_fwd", B=32, T=200, **attn)["bound_by"] == "bytes"
    served = kb("flash_attention_fwd", B=16, T=601, **attn)
    assert round(served["bound_ms"], 4) == 0.0060 and served["bound_by"] == "operations"
    assert round(kb("flash_attention_fwd", B=16, H=8, Kh=1, T=1601, D=64)["bound_ms"], 4) == 0.0849
    assert round(kb("flash_attention_bwd", B=32, T=200, **attn)["bound_ms"], 4) == 0.0065
    assert round(kb("ctc_fwd", B=32, T=200, V=56, L=64)["bound_ms"], 4) == 0.0014
    assert round(kb("ctc_bwd", B=32, T=200, V=56, L=64)["bound_ms"], 4) == 0.0018
    assert round(kb("swiglu_fwd", M=6400, C=256, F=1024)["bound_ms"], 4) == 0.0102
    assert round(kb("swiglu_fwd", M=6404, C=512, F=2048)["bound_ms"], 4) == 0.0407
    assert frozen.PEAK_FLOPS_BY_CARD["NVIDIA H100 80GB HBM3"] == 989e12


def test_frozen_flops_agree_with_the_port():
    """The copy of model_forward_flops equals the port's bench's, and the
    headline's B=128 x 8 s at ~43 ms a call is PERF.md's mfu of ~0.036."""
    from turkish_asr_torch import bench
    from turkish_asr_torch.models.conformer import ModelConfig

    for cfg in (ModelConfig(n_classes=56), ModelConfig(d_model=512, n_heads=8, n_blocks=17,
                                                        n_classes=56)):
        for sec in (1.0, 4.5, 8.0, 31.9):
            assert frozen.model_forward_flops(cfg, sec) == bench.model_forward_flops(cfg, sec)
    flops = 128 * frozen.model_forward_flops(ModelConfig(n_classes=56), 8.0)
    assert 0.035 < flops / 0.043 / frozen.PEAK_FLOPS_BY_CARD["NVIDIA H100 80GB HBM3"] < 0.037


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_measuring_code_of_the_program_and_a_plain_reference():
    sources = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    for p in sources:
        for name in _imports(p):
            assert name.split(".", 1)[0] not in common.JAX_NAMES, (p, name)
            assert name not in ("turkish_asr_torch.bench", "chip_smoke"), (p, name)
            assert not name.startswith("turkish_asr_torch.scripts"), (p, name)
            if "reference" in p.parts:
                assert not name.startswith("turkish_asr_torch"), (p, name)


def test_importing_the_harness_loads_no_jax():
    code = ("import sys, importlib; from asr_bench import common\n"
            "for m in ('run', 'calibrate', 'faults', 'readers', 'trace', 'weights', 'served', "
            "'traffic', 'frozen', 'reference.conformer_ctc', 'reference.judge', "
            "'reference.bpe'):\n"
            "    importlib.import_module('asr_bench.' + m)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'turkish_asr_torch']\n"
            "b = common.benchmark()\n"
            "for w in b['workloads']:\n"
            "    mix = common.load_json('traffic', w['traffic'])\n"
            "    common.load_module('drivers', mix['driver'])\n"
            "for m in b['per_layer']:\n"
            "    common.load_module('metrics', m['name'])\n"
            "import turkish_asr_torch.inference\n"
            "print(common.jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                                                      "USE_JAX": "0", "USE_TF": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert common.jax_modules(["turkish_asr_torch.models", "numpy"]) == []
    assert common.jax_modules(["jax.numpy", "turkish_asr_tpu.ops"]) == ["jax", "turkish_asr_tpu"]


def test_trace_reduction():
    """Kernels belong to the harness span open on their launching thread;
    the spin markers bound the stretch and tie the clocks."""
    from asr_bench import readers, trace

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    def launch(tid, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                "ts": ts, "args": {"correlation": corr}}

    # host seconds 10.0 .. 10.001 map to trace 5000 .. 6000 us
    events = [launch(1, 5000, 1), kernel("spin_kernel", 5001, 1, 1),
              launch(2, 5100, 2), kernel("flash_fwd_kernel", 5200, 100, 2),
              launch(2, 5150, 3), kernel("nvjet_gemm", 5300, 100, 3),
              launch(1, 5400, 4), kernel("elementwise_kernel", 5500, 200, 4),
              launch(1, 6000, 5), kernel("spin_kernel", 6001, 1, 5)]
    t = trace.Trace(events, 10.0, 10.001)
    assert (t.t0, t.t1, t.window_s) == (5000, 6000, 0.001)
    assert abs(t.busy_s() - 400e-6) < 1e-12
    spans = trace.Spans()
    spans.items = [("attn_fwd", (92, 2), 10.0000995, 10.000160, {"B": 1, "H": 4, "Kh": 1,
                                                                 "T": 8, "D": 64}),
                   ("step", (1, 91), 10.0003, 10.0009, {}),
                   ("other", (77, 78), 10.0003, 10.0009, {})]
    got = t.under(spans, "attn_fwd")
    assert len(got) == 1 and [e[0] for e in got[0][1]] == ["flash_fwd_kernel", "nvjet_gemm"]
    ctx = type("Ctx", (), {"trace": t, "spans": spans, "stats": {}})()
    assert abs(readers.idle_share(ctx) - 60.0) < 1e-9
    assert abs(readers.nongemm_share(ctx) - 50.0) < 1e-9
    bound = frozen.kernel_bounds("flash_attention_fwd", B=1, H=4, Kh=1, T=8, D=64)["bound_ms"]
    assert abs(readers.roofline(ctx, {"attn_fwd": "flash_attention_fwd"})
               - 100.0 * bound * 1e3 / 200.0) < 1e-9
    gaps = t.breakdown(spans)["idle_gaps"]
    assert gaps[0][0] == "step" and abs(gaps[0][1] - 300e-6) < 1e-12
    assert trace.Trace([kernel("k", 0.0, 0.0, 9)], 0.0, 1.0).timed == 0
