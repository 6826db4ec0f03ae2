"""Readings for a cell's limits, on the card at the cell's own size.

    python -m asr_bench.calibrate --workload <name> --seeds 11,12,... --seconds 4 \
        [--controls fp8] [--fault altered_token]

Runs the cell once a seed, in one process (the card and the program's
kernels are set up once), and prints a JSON line a seed: the program's
compared numbers, with ``--controls`` the same numbers of the reference in
that precision put in the program's place, and with ``--fault`` those of
the program with a fault of ``asr_bench/faults.py`` planted under its timed
path. The benchmark's own runs do not run this; the limits in
``asr_bench/limits/`` were set from its readings (PERF.md).
"""

import argparse
import gc
import json
import sys

from asr_bench import common, faults, run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--controls", default="")
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    bench = common.benchmark()
    entry, _ = common.cell_of(bench, args.workload)
    run._environment(common.load_json("traffic", entry["traffic"]))
    controls = tuple(c for c in args.controls.split(",") if c)
    import torch

    if not torch.cuda.is_available():
        print("asr_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.Cell.named(bench, args.workload, seed, args.seconds)
        if args.fault:
            cell.fault = faults.FAULTS[args.fault]
        out = run.execute(cell, bench, controls=controls)
        line = {"seed": seed, "fault": args.fault, "correct": out[0], "failed": out[2],
                "metrics": {k: v["value"] for k, v in out[3].items()},
                "checks": {n: v for n, v, _ in out[5]},
                "memory_peak_bytes": out[4]["memory_peak_bytes"]}
        if controls:
            line["controls"] = {p: {n: v for n, v, _ in rows} for p, rows in out[7].items()}
        print(json.dumps(line), flush=True)
        del cell, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
