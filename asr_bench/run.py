"""Run one cell of the port's benchmark once.

    python -m asr_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The cell's
driver sets the program up (weights and inputs from ``--seed``, every
shape the cell's traffic uses warmed), measures for ``--seconds``, then
reads the peak device memory, frees the program's state and holds what the
timed path produced against the plain reference. With ``--trace 0`` the
result line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from the harness's spans and a device trace of a
stretch of the window.

It exits with a code other than 0, and prints no result, where the card or
the program is missing, where fewer cards are visible than the cell asks
for, or where JAX or the JAX package is loaded once the window has closed.
Build and kernel caches stay under ``build/`` in the checkout; temporary
files go under ``TMPDIR``.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from asr_bench import common  # noqa: E402
from asr_bench.trace import Spans  # noqa: E402


def _environment(mix=None):
    """Keep libraries from loading JAX, every cache in the checkout, and the
    host's thread pools at the mix's ``host_threads`` (before torch loads)."""
    if mix and mix.get("host_threads"):
        for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[name] = str(mix["host_threads"])
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_TORCH"] = "1"
    build = common.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


class Cell:
    """One run of one cell: its settings and what its driver records."""

    def __init__(self, workload, chips, config, mix, seed, seconds, trace=False, device="cuda"):
        self.workload = workload
        self.chips = int(chips)
        self.config = config
        self.mix = mix
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.spans = Spans()
        self.window_start = None
        self.stats = {}           # the cell's counts, read by the metric readers
        self.profile = None       # the Profile of a traced run
        self.fault = None         # a fault planted under the timed path (checks of the check)

    @classmethod
    def named(cls, bench, workload, seed, seconds, trace=False):
        entry, _ = common.cell_of(bench, workload)
        return cls(workload, entry["chips"], common.load_json("configs", entry["config"]),
                   common.load_json("traffic", entry["traffic"]), seed, seconds, trace)


class LayerContext:
    """What a per-layer metric's reader reads."""

    def __init__(self, cell, trace, card_name):
        from asr_bench import frozen

        self.cell = cell
        self.spans = cell.spans
        self.stats = cell.stats
        self.trace = trace
        self.cfg = common.ModelConfig(cell.config)
        self.card = card_name
        self.peak_flops = frozen.PEAK_FLOPS_BY_CARD.get(card_name)


def execute(cell, bench, limits=None, controls=()):
    """Set up, measure, read the per-layer metrics when tracing, free the
    program and check it. Returns (correct, attempted, failed, metrics,
    device, checks, breakdown); with ``controls`` (precisions, such as
    "fp8") also {precision: the control's checks}: the reference in that
    precision put in the program's place, judged as the program is."""
    import torch

    on_card = cell.device != "cpu"
    driver = common.load_module("drivers", cell.mix["driver"]).Driver(cell)
    if cell.trace:
        from asr_bench.trace import prime
        prime()
    driver.setup()
    driver.window()
    setup_s = cell.window_start - PROCESS_START
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips)) if on_card else 0
    e2e = dict(driver.end_to_end(), setup_s=setup_s)
    from asr_bench import frozen

    card_name, watts = frozen.card("cuda:0") if on_card else (None, None)
    trace = cell.profile.best() if cell.profile is not None else None
    if cell.profile is not None:
        for k, t in enumerate(cell.profile.traces):
            print(f"asr_bench: trace stretch {k}: {len(t.device)} device events, {t.timed} timed, "
                  f"{t.markers} markers, clocks {'tied' if t.offset is not None else 'not tied'}, "
                  f"{t.window_s:.4f} s", file=sys.stderr)
    metrics = {}
    if cell.trace:
        layer = LayerContext(cell, trace, card_name)
        for m in common.metrics_of(bench, cell.workload, "per_layer"):
            value = common.load_module("metrics", m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in common.metrics_of(bench, cell.workload, "end_to_end")}
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check()
    control = {p: common.verdict(driver.check(p), limits or {})[1] for p in controls}
    if limits is None:
        path = common.HERE / "limits" / f"{cell.workload}.json"
        limits = common.load_json("limits", cell.workload) if path.is_file() else {}
    correct, rows = common.verdict(checks, limits)
    correct = correct and driver.failed == 0
    device = {"platform": "gpu" if on_card else "cpu", "kind": card_name, "count": cell.chips,
              "memory_peak_bytes": int(peak), "power_limit_w": watts}
    breakdown = None
    if cell.trace:
        device["busy_s"] = trace.busy_s() if trace is not None else 0.0
        device["window_s"] = trace.window_s if trace is not None else 0.0
        breakdown = trace.breakdown(cell.spans) if trace is not None else None
    out = (correct, driver.attempted, driver.failed, metrics, device, rows, breakdown)
    return out + (control,) if controls else out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = common.benchmark()
    cell = Cell.named(bench, args.workload, args.seed, args.seconds, args.trace)
    _environment(cell.mix)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"asr_bench: the cell asks for {cell.chips} CUDA device(s); {have} visible",
              file=sys.stderr)
        return 2
    correct, attempted, failed, metrics, device, rows, breakdown = execute(cell, bench)
    found = common.jax_modules()
    if found:
        print(f"asr_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"asr_bench: {cell.workload} seed {cell.seed}: attempted {attempted}, failed {failed}",
          file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(common.result_line(correct, attempted, failed, metrics, device, rows, breakdown))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — a run that fails prints no result
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
