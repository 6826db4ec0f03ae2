"""The attention kernels' launch plan, ``ops/flash_attention.py::attention_plan``
(pure shape arithmetic, no card): every grid covers every row with no
empty block, tile or chunk, and the main path's shapes get the grids the
kernels were measured with. The kernels refuse any other plan
(``tests/test_torch_cuda.py`` runs them on the card)."""

import pytest

from turkish_asr_torch.ops.flash_attention import GROUPS, TILE, attention_plan

# (B, H, Kh, T): the main path's (training, the long served bucket), bench
# config 5's, the MHA A/B's and ragged edges down to one row.
SHAPES = [(32, 4, 1, 200), (16, 4, 1, 601), (16, 8, 1, 1601), (4, 8, 1, 1601),
          (4, 4, 4, 801), (3, 2, 2, 9), (1, 4, 1, 1), (1, 1, 1, 1), (2, 1, 1, 129)]


@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("B,H,Kh,T", SHAPES)
def test_every_grid_covers_every_row_without_an_empty_block(B, H, Kh, T, fp32):
    plan = attention_plan(B, H, Kh, T, 64, fp32, 132)
    rows = H * T if Kh == 1 else T
    for grid in (plan.fwd_grid, plan.dq_grid):
        assert grid[1:] == (1, B * Kh)
        assert (grid[0] - 1) * plan.block_rows < rows <= grid[0] * plan.block_rows
    keys, chunks, bk = plan.dkdv_grid
    assert bk == B * Kh and chunks == plan.chunks
    assert (keys - 1) * plan.block_rows < T <= keys * plan.block_rows
    assert plan.chunk_rows % TILE == 0
    assert (plan.chunks - 1) * plan.chunk_rows < rows <= plan.chunks * plan.chunk_rows


@pytest.mark.parametrize("B,H,Kh,T", SHAPES)
def test_blocks_and_stages_follow_the_instance(B, H, Kh, T):
    """bf16: GROUPS consumer warpgroups a block (128 rows or keys); fp32
    one (64). The forward's ring has two stages; the dk/dv kernel's two
    only for bf16 at D <= 64 (shared memory)."""
    bf16 = TILE * GROUPS
    for D, fp32, block, bwd_stages in ((64, False, bf16, 2), (128, False, bf16, 1),
                                       (40, False, bf16, 2), (64, True, TILE, 1),
                                       (128, True, TILE, 1)):
        plan = attention_plan(B, H, Kh, T, D, fp32, 132)
        assert (plan.block_rows, plan.fwd_stages, plan.bwd_stages) == (block, 2, bwd_stages)


@pytest.mark.parametrize("B,H,Kh,T", SHAPES)
def test_ds_pitch_is_the_rows_rounded_to_16_bytes(B, H, Kh, T):
    rows = H * T if Kh == 1 else T
    pitch = attention_plan(B, H, Kh, T, 64, False, 132).pitch
    assert pitch % 8 == 0 and rows <= pitch < rows + 8


def test_main_path_grids():
    """On 132 slots (the H100, one bf16 D=64 dk/dv block an SM): training
    B=32, T'=200: 224 forward and dq blocks (7 of 128 folded rows per
    batch row), 128 dk/dv blocks in two chunks of 7 row tiles; the served
    B=16, T'=601: 304 forward blocks; config 5's B=16 forward 1616 blocks
    and its B=4 backward 260 dk/dv blocks in five chunks."""
    train = attention_plan(32, 4, 1, 200, 64, False, 132)
    assert (train.fwd_grid, train.dkdv_grid, train.dq_grid, train.pitch) == (
        (7, 1, 32), (2, 2, 32), (7, 1, 32), 800)
    assert attention_plan(16, 4, 1, 601, 64, False, 132).fwd_grid == (19, 1, 16)
    assert attention_plan(16, 8, 1, 1601, 64, False, 132).fwd_grid == (101, 1, 16)
    longform = attention_plan(4, 8, 1, 1601, 64, False, 132)
    assert (longform.dkdv_grid, longform.chunk_rows, longform.dq_grid) == (
        (13, 5, 4), 41 * TILE, (101, 1, 4))


def test_plan_is_cached():
    """A launch pays for a dictionary lookup, not the chunk search."""
    assert attention_plan(32, 4, 1, 200, 64, False, 132) is \
        attention_plan(32, 4, 1, 200, 64, False, 132)
