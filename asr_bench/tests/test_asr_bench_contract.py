"""BENCHMARK.json and the harness's pieces, found by name, on the CPU."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from asr_bench import common

ROOT = common.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["asr_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("asr_bench/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:  # every listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell: set-up, another end-to-end metric, a per-layer metric
        assert len(common.metrics_of(bench, w, "end_to_end")) >= 2
        assert common.metrics_of(bench, w, "per_layer")


def test_check_fits_its_time(bench):
    n = 24  # later changes add cells up to the contract's 24
    runs = 2 + 14 * n
    assert runs * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_every_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        mix = common.load_json("traffic", w["traffic"])
        common.load_json("configs", w["config"])
        common.load_json("limits", w["name"])
        assert hasattr(common.load_module("drivers", mix["driver"]), "Driver")
    for m in bench["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path, bench):
    """A configuration, a mix, a driver and a metric added as files and
    entries: found by name, and no file that was there is edited."""
    shutil.copytree(ROOT / "asr_bench", tmp_path / "asr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "asr_bench")
    here = tmp_path / "asr_bench"
    cfg = dict(common.load_json("configs", "flagship"), name="flagship_deep", n_blocks=12)
    (here / "configs" / "flagship_deep.json").write_text(json.dumps(cfg))
    mix = dict(common.load_json("traffic", "transcribe_16_32s"), driver="transcribe_beam")
    (here / "traffic" / "beam_8s.json").write_text(json.dumps(mix))
    (here / "drivers" / "transcribe_beam.py").write_text(
        "from asr_bench.drivers.transcribe import Driver as Base\n\n\n"
        "class Driver(Base):\n    pass\n")
    (here / "metrics" / "beam_ms.transcribe.py").write_text("def read(ctx):\n    return None\n")
    (here / "limits" / "flagship_deep.beam_8s.json").write_text(
        json.dumps({"text_gap": {"limit": 1.0}}))
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(bench["configs"][0], name="flagship_deep",
                                              file="asr_bench/configs/flagship_deep.json")]
    new["workloads"] = bench["workloads"] + [{"name": "flagship_deep.beam_8s",
                                              "config": "flagship_deep", "traffic": "beam_8s",
                                              "chips": 1, "why": "a new cell"}]
    new["per_layer"] = bench["per_layer"] + [{
        "name": "beam_ms.transcribe", "unit": "ms", "better": "lower", "source": "program_span",
        "layer": "decode", "moves": "transcribe_audio_s_per_s",
        "workloads": ["flagship_deep.beam_8s"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    got = common.benchmark(tmp_path)
    entry, _ = common.cell_of(got, "flagship_deep.beam_8s")
    assert common.load_json("configs", entry["config"], here)["n_blocks"] == 12
    mix = common.load_json("traffic", entry["traffic"], here)
    assert common.load_module("drivers", mix["driver"], here).Driver
    assert [m["name"] for m in common.metrics_of(got, "flagship_deep.beam_8s", "per_layer")] == [
        "beam_ms.transcribe"]
    assert common.load_module("metrics", "beam_ms.transcribe", here).read(None) is None
    after = _digests(here)
    assert all(after[p] == d for p, d in before.items())


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "asr_bench.run", "--workload",
                          "flagship.transcribe_16_32s", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the harness: no result."""
    shutil.copytree(ROOT / "asr_bench", tmp_path / "asr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "asr_bench.run", "--workload",
                          "flagship.transcribe_16_32s", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_result_line_keys_and_order():
    ok, rows = common.verdict([("text_gap", 0.1), ("loss_gap", float("nan"))],
                              {"text_gap": {"limit": 0.5}, "loss_gap": {"limit": 1.0}})
    assert not ok
    line = json.loads(common.result_line(ok, 10, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                                         {"platform": "gpu", "kind": "x", "count": 1,
                                          "memory_peak_bytes": 1}, rows))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["checks"]["text_gap"] == {"value": 0.1, "limit": 0.5}
    assert common.verdict([("text_gap", 0.1)], {})[0] is False  # no limit, no pass
