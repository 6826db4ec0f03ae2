"""What every cell shares: finding a cell's pieces by name, the card, the
cell's limits, and the run's result line.

Every piece is found by the name ``BENCHMARK.json`` gives it:

- a configuration: ``asr_bench/configs/<config>.json``
- a traffic mix: ``asr_bench/traffic/<traffic>.json``; its ``driver`` key
  names the code that drives an entry point, ``asr_bench/drivers/<driver>.py``
- a per-layer metric's reader: ``asr_bench/metrics/<metric>.py``
- a cell's limits on the numbers that decide ``correct``:
  ``asr_bench/limits/<workload>.json``

A later change adds a model, a mix, a driver or a metric by adding such
files and entries; none of these files lists the others.
"""

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "turkish_asr_tpu")


def benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind, name, here=HERE):
    path = Path(here) / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind, name, here=HERE):
    """The module of ``asr_bench/<kind>/<name>.py`` (a name may hold dots)."""
    path = Path(here) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"asr_bench.{kind}.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_of(bench, workload):
    """(the workload's entry, its configuration's entry) of ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def metrics_of(bench, workload, kind):
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        out.append(m)
    return out


def jax_modules(modules=None):
    """The top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared as whole names (the port's name begins with the
    JAX package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in JAX_NAMES)


class ModelConfig:
    """The sizes of a configuration file, as attributes."""

    def __init__(self, sizes):
        self.__dict__.update(sizes)


def verdict(checks, limits):
    """(correct, [(name, value, limit)]): each number compared against its
    limit; a number without a limit, or not finite, fails."""
    rows, ok = [], True
    for name, value in checks:
        limit = (limits.get(name) or {}).get("limit")
        good = (limit is not None and value is not None and value == value
                and value <= limit)
        ok &= bool(good)
        rows.append((name, value, limit))
    return ok, rows


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None):
    """The last line of standard output: one JSON object, the compared
    numbers last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(line)
