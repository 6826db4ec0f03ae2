"""The CTC kernels' launch plan (turkish_asr_torch/ops/ctc.py ctc_plan) and
the index arguments the wrappers hand them: pure shape logic, no card
needed. Every shape chip_smoke.py's CTC phase runs, the widest target the
wrappers take (S = 8192) and T' up to 3000 get a plan whose lanes cover S
within the H100's 232,448 bytes of shared memory a block; the training
step's shape takes the one-warp path."""

import pytest
import torch

import chip_smoke
from turkish_asr_torch.ops import ctc

SMEM = 232_448
SHAPES = sorted({(2 * L + 1, T) for T in chip_smoke.CTC_SHAPES["T"]
                 for L in chip_smoke.CTC_SHAPES["L"]}
                | {(2 * L + 1, T) for T, L, _ in chip_smoke.CTC_EDGES}
                | {(8192, T) for T in (1, 2, 40, 200, 3000)}
                | {(S, 3000) for S in (1, 3, 65, 97, 129, 1025, 1055, 1057, 4097, 8191)}
                | {(129, T) for T in (1, 2, 31, 32, 33, 77, 800, 3000)})


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("S,T", SHAPES)
def test_plan_covers_the_lanes_within_shared_memory(kernel, S, T):
    p = ctc.ctc_plan(kernel, S, T)
    assert 32 * p.warps * p.lanes >= S
    assert p.lanes in ctc.LANE_COUNTS and p.lanes % 2 == 1  # odd: no bank conflicts
    assert p.smem <= SMEM
    assert 1 <= p.chunk <= min(T, ctc.MAX_CHUNK)
    assert p.threads == 32 * (p.warps + ctc.PRODUCER_WARPS[kernel]) <= 1024
    if p.warps == 1:
        i = ctc.LANE_COUNTS.index(p.lanes)
        assert i == 0 or 32 * ctc.LANE_COUNTS[i - 1] < S  # the fewest lanes that cover S
    else:
        assert p.lanes == ctc.WIDE_LANES and p.warps <= ctc.WIDE_WARPS
        assert 32 * ctc.LANE_COUNTS[-1] < S
    # A chunk one frame longer would not fit, unless it is already the most.
    if p.chunk < min(T, ctc.MAX_CHUNK):
        assert ctc._smem(kernel, S, p.warps, p.lanes, p.chunk + 1) > SMEM


def test_the_training_step_takes_the_warp_path():
    """B=32, T'=200, L=64 (S = 129): one recursion warp of 5 lanes a
    thread, 32-frame chunks; 160 threads forward, 288 backward."""
    S, T = 2 * chip_smoke.CTC_MAIN["L"] + 1, chip_smoke.CTC_MAIN["T"]
    assert ctc.ctc_plan("fwd", S, T) == (1, 5, 32, 4 * (2 * 32 * 160 + 4 + 2 + 129), 160)
    assert ctc.ctc_plan("bwd", S, T) == (1, 5, 32, 4 * (4 * 32 * 160 + 4 + 2 * 129) + 129, 288)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_the_warp_path_ends_at_32_x_33_lanes(kernel):
    assert ctc.ctc_plan(kernel, 1025, 200)[:2] == (1, 33)  # the longest target bucket, L=512
    assert ctc.ctc_plan(kernel, 1055, 200)[:2] == (1, 33)
    assert ctc.ctc_plan(kernel, 1057, 200)[:2] == (2, ctc.WIDE_LANES)
    assert ctc.ctc_plan(kernel, 8192, 200)[:2] == (16, ctc.WIDE_LANES)


@pytest.mark.parametrize("kernel,S", [("fwd", 0), ("bwd", 8193), ("grad", 129)])
def test_plan_refuses_what_the_kernels_do_not_take(kernel, S):
    with pytest.raises(ValueError):
        ctc.ctc_plan(kernel, S, 200)


@pytest.mark.parametrize("dtypes,flags", [
    ((torch.int32, torch.int32, torch.int32), 0),
    ((torch.int64, torch.int32, torch.int32), 1),
    ((torch.int32, torch.int64, torch.int64), 6),
    ((torch.int64, torch.int64, torch.int64), 7),
    ((torch.int16, torch.uint8, torch.int64), 4),
])
def test_index_args_keep_int32_and_int64(dtypes, flags):
    """int32 and int64 go to the kernels as they are (no cast kernel on the
    card), other integer types as int32; the flags mark the int64 ones."""
    given = [torch.arange(6, dtype=d).reshape(2, 3) if i == 0 else torch.tensor([3, 1], dtype=d)
             for i, d in enumerate(dtypes)]
    out, got = ctc._index_args(*given)
    assert got == flags
    for x, y in zip(given, out):
        assert y.is_contiguous() and torch.equal(x.long(), y.long())
        assert y.dtype == (x.dtype if x.dtype in (torch.int32, torch.int64) else torch.int32)
        if x.dtype in (torch.int32, torch.int64):
            assert y.data_ptr() == x.data_ptr()  # no copy


def test_ab_ctc_times_chip_smokes_ctc_shapes():
    """The CTC A/B's shapes are chip_smoke.py's CTC grid, the training
    step's first."""
    from turkish_asr_torch.scripts import ab_ctc
    shapes = list(ab_ctc.shapes())
    assert shapes[0] == chip_smoke.CTC_MAIN == ab_ctc.MAIN
    grid = {(s["T"], s["L"], s["V"]) for s in shapes}
    assert grid == {(T, L, V) for T in chip_smoke.CTC_SHAPES["T"]
                    for L in chip_smoke.CTC_SHAPES["L"] for V in chip_smoke.CTC_SHAPES["V"]}
    assert len(shapes) == len(grid) and all(s["B"] == chip_smoke.CTC_SHAPES["B"] for s in shapes)


def test_ab_ctc_needs_a_card(monkeypatch):
    from turkish_asr_torch.scripts import ab_ctc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ab_ctc.main([])
