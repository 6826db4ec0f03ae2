"""A run of each driver with its timed path broken underneath, and the
control in the program's place, at a tiny size on the CPU: ``correct``
comes out false.

These drive everything of a run but the look for a card
(``asr_bench.run.execute``) on a model of the configuration's block at
d_model 64 and two blocks. The card's readings at the cells' own sizes,
from which the limits were set, are in PERF.md (``asr_bench/calibrate.py``).
"""

import pytest

from asr_bench import common, faults, run

TINY = dict(common.load_json("configs", "flagship"), d_model=64, n_heads=2, n_blocks=2)


def transcribe_cell(seed=1):
    mix = dict(common.load_json("traffic", "transcribe_16_32s"), pool=6, paths_per_call=4,
               batch_size=2, check_files=3, clip_seconds={"dist": "uniform", "min": 1.5,
                                                         "max": 3.0})
    return run.Cell("flagship.transcribe_16_32s", 1, TINY, mix, seed, 1.0, device="cpu")


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def readings(cell, bench, controls=()):
    out = run.execute(cell, bench, controls=controls)
    return out[0], {n: v for n, v, _ in out[5]}, out


def test_sound_serving_run_is_correct_and_an_altered_token_is_not(bench):
    ok, got, out = readings(transcribe_cell(), bench, controls=("fp8",))
    assert ok, got
    control = {n: v for n, v, _ in out[7]["fp8"]}
    limits = common.load_json("limits", transcribe_cell().workload)
    assert control["text_gap"] > limits["text_gap"]["limit"]
    cell = transcribe_cell()
    cell.fault = faults.altered_token
    ok, got, _ = readings(cell, bench)
    assert not ok and got["text_gap"] > limits["text_gap"]["limit"]
