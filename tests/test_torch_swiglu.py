"""The fused SwiGLU FFN's plain PyTorch versions against scripts/ab_swiglu.py:
``swiglu_fused_ref`` (the CPU path of ``ops/swiglu.py::swiglu``) against
the Pallas kernel ``swiglu_pallas`` run in interpret mode on the CPU, and
``swiglu_chain`` against the jitted ``swiglu_xla``; the A/B's inputs; the
wrapper's checks; the entry point without a card.

Tolerance 2^-7 max|y|, one to two bf16 ulps of the largest output: both
sides sum exact fp32 products of bf16 values in another order, so h can
differ in its last fp32 bits, and the bf16 roundings of g (and, in the
chain, of h) can then land one ulp apart. Measured on the CPU: 7.6e-6
and 7.8e-3 (fused), 0 and 7.8e-3 (chain).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turkish_asr_torch.ops import swiglu as sw
from turkish_asr_torch.ops._swiglu import swiglu_chain, swiglu_fused_ref
from turkish_asr_torch.scripts.ab_swiglu import make_inputs
from turkish_asr_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (M, C, F, tm of the JAX kernel): narrow, the flagship FFN, Conformer-L's
# (C=512, F=2048).
SHAPES = [(512, 32, 64, 128), (256, 256, 1024, 128), (128, 512, 2048, 128)]


@pytest.fixture(scope="module")
def ab():
    """scripts/ab_swiglu.py, loaded without writing its bytecode and with
    the sys.path entry it adds taken out again."""
    path, write = list(sys.path), sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_ab_swiglu", os.path.join(ROOT, "scripts", "ab_swiglu.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.dont_write_bytecode = write
        sys.path[:] = path
    return module


def _case(M, C, F, seed):
    """numpy fp32 (x, w1, b1, w2, b2) with nonzero biases."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, C)).astype(np.float32),
            (rng.standard_normal((C, 2 * F)) * 0.05).astype(np.float32),
            (rng.standard_normal((1, 2 * F)) * 0.1).astype(np.float32),
            (rng.standard_normal((F, C)) * 0.05).astype(np.float32),
            (rng.standard_normal((1, C)) * 0.1).astype(np.float32))


def _jax_args(x, w1, b1, w2, b2):
    return (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w1).astype(jnp.bfloat16),
            jnp.asarray(b1), jnp.asarray(w2).astype(jnp.bfloat16), jnp.asarray(b2))


def _f32(y):
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


@pytest.mark.parametrize("M,C,F,tm", SHAPES)
def test_swiglu_matches_the_jax_kernel(ab, M, C, F, tm):
    case = _case(M, C, F, seed=M + C)
    with pltpu.force_tpu_interpret_mode():
        want = _f32(ab.swiglu_pallas(*_jax_args(*case), tm=tm))
    got = sw.swiglu(*sw.args_from_numpy(*case, "cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == (M, C)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("M,C,F,tm", SHAPES)
def test_chain_matches_swiglu_xla(ab, M, C, F, tm):
    case = _case(M, C, F, seed=M + C + 1)
    want = _f32(jax.jit(ab.swiglu_xla)(*_jax_args(*case)))
    got = swiglu_chain(*sw.args_from_numpy(*case, "cpu"))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_inputs_are_the_jax_scripts_draws_bit_for_bit(ab, monkeypatch):
    """make_inputs + args_from_numpy give the very bf16 and fp32 arrays the
    JAX script's main() hands to its timer."""
    seen = {}

    def timer(fn, x, args, n=50):
        seen.setdefault("x", x)
        seen.setdefault("args", args)
        return 0.0

    monkeypatch.setattr(ab, "timeit_chained", timer)
    monkeypatch.setattr(ab, "swiglu_pallas", lambda x, *a, tm: x)
    monkeypatch.setattr(sys, "argv", ["ab_swiglu.py", "96", "40", "24"])
    ab.main()
    got = sw.args_from_numpy(*make_inputs(96, 40, 24), "cpu")
    want = (seen["x"], *seen["args"])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert np.array_equal(g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
                              else g.numpy(),
                              w.view(np.int16) if w.dtype == jnp.bfloat16 else w)


def test_args_from_numpy_rounds_to_nearest_even():
    """Ties go to the even bf16 mantissa, as jnp.astype rounds them."""
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1 + 2 ** -8 + 2 ** -20],
                    np.float32)
    got = sw.args_from_numpy(ties, ties, ties, ties, ties, "cpu")[0]
    want = np.asarray(jnp.asarray(ties).astype(jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got.view(torch.int16).numpy(), want)
    assert got.float().tolist() == [1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -7]


def test_ragged_rows_are_all_written():
    """M = 300 is no multiple of any row tile: every row is written and
    equals the same computation made one row at a time."""
    x, w1, b1, w2, b2 = sw.args_from_numpy(*_case(300, 32, 64, seed=3), "cpu")
    y = sw.swiglu(x, w1, b1, w2, b2, tm=64)
    rows = torch.cat([swiglu_fused_ref(x[i:i + 1], w1, b1, w2, b2) for i in range(300)])
    assert y.shape == (300, 32) and torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), rows.float(), rtol=0,
                               atol=2.0 ** -7 * rows.float().abs().max().item())


def test_cpu_tensors_launch_no_kernel():
    before = tracing.counters()["swiglu_fwd"]
    sw.swiglu(*sw.args_from_numpy(*_case(16, 8, 8, seed=4), "cpu"))
    assert tracing.counters()["swiglu_fwd"] == before


def _refused(change):
    x, w1, b1, w2, b2 = sw.args_from_numpy(*_case(8, 16, 12, seed=5), "cpu")
    return change(x, w1, b1, w2, b2)


@pytest.mark.parametrize("change,match", [
    (lambda x, w1, b1, w2, b2: (x, w1[:, :-1], b1, w2, b2, 32), "w1 must be"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1, w2[:, :-1], b2, 32), "w1 must be"),
    (lambda x, w1, b1, w2, b2: (x[None], w1, b1, w2, b2, 32), r"x must be \(M, C\)"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1[:, :-1], w2, b2, 32), "b1"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1, w2, b2.reshape(4, 4), 32), "b2"),
    (lambda x, w1, b1, w2, b2: (x.float(), w1, b1, w2, b2, 32), "must be bf16"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1, w2.half(), b2, 32), "must be bf16"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1.bfloat16(), w2, b2, 32), "must be fp32"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1, w2, b2, 32), "tm must be one of"),
    (lambda x, w1, b1, w2, b2: (x[:0], w1, b1, w2, b2, 32), "M >= 1"),
    (lambda x, w1, b1, w2, b2: (x, w1, b1, w2, b2.requires_grad_(), 32), "forward only"),
    (lambda x, w1, b1, w2, b2: (x.requires_grad_(), w1, b1, w2, b2, 32), "requires grad"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    *args, tm = _refused(change)
    with pytest.raises(ValueError, match=match):
        sw.swiglu(*args, tm=tm)


def test_wrapper_refuses_more_than_512_columns():
    x, w1, b1, w2, b2 = sw.args_from_numpy(*_case(4, 520, 8, seed=6), "cpu")
    with pytest.raises(ValueError, match="C <= 512"):
        sw.swiglu(x, w1, b1, w2, b2)


def test_wrapper_takes_512_columns_at_its_default_tile():
    """C=512 runs at tm=64 unless told otherwise; tm=128 takes C <= 256."""
    args = sw.args_from_numpy(*_case(4, 512, 8, seed=7), "cpu")
    assert sw.default_tile(512) == 64 and sw.default_tile(256) == sw.DEFAULT_TILE == 128
    assert sw.swiglu(*args).shape == (4, 512)
    with pytest.raises(ValueError, match="tm=128 takes C <= 256"):
        sw.swiglu(*args, tm=128)


def test_entry_point_needs_a_cuda_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "turkish_asr_torch.scripts.ab_swiglu",
                           "64", "32", "64"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout == ""


SMEM = 232_448  # the H100's dynamic shared memory a block
SMS = 132  # the H100 SXM's streaming multiprocessors


def _check_plan(p, M, F, tm):
    """A plan's invariants: the blocks of one F split share rows, the row
    tiles cover M with no cluster past it, the split divides F's chunks
    among at most as many blocks as there are chunks, shared memory fits a
    block, and the split is the fewest blocks that put a block on half the
    132 SMs."""
    chunk = sw.INSTANCES[tm]["chunk"]
    assert (p.chunk, p.stages, p.groups) == (chunk, sw.INSTANCES[tm]["stages"], 3)
    assert p.cluster in sw.FSPLITS and p.cluster <= -(-F // chunk)
    assert p.grid % p.cluster == 0
    tiles = p.grid // p.cluster
    assert tiles * tm >= M > (tiles - 1) * tm
    assert p.smem <= SMEM
    assert 2 * p.grid >= SMS or p.cluster == min(sw.FSPLITS[-1], -(-F // chunk))
    assert p.cluster == 1 or 2 * tiles * (p.cluster // 2) < SMS


@pytest.mark.parametrize("tm", sw.ROW_TILES)
@pytest.mark.parametrize("M", [1, 5, 3000, 6400, 6401, 25600])
def test_plan_covers_the_rows_within_shared_memory(M, tm):
    """The flagship FFN (C=256, F=1024) at both row tiles."""
    p = sw.swiglu_plan(M, 256, 1024, tm, SMS)
    _check_plan(p, M, 1024, tm)
    assert p.aligned


@pytest.mark.parametrize("M", [1, 5, 301, 6404, 25616])
def test_plan_at_conformer_l_width(M):
    """Conformer-L's FFN (C=512, F=2048) at its one row tile, 64: the
    training step's M=6404 and the forward's 25616 fill the card with
    unsplit F (101 and 401 blocks); small M split F up to 8 ways."""
    assert sw.row_tiles(512) == (64,)
    p = sw.swiglu_plan(M, 512, 2048, 64, SMS)
    _check_plan(p, M, 2048, 64)
    assert p.aligned
    assert p.cluster == {1: 8, 5: 8, 301: 8, 6404: 1, 25616: 1}[M]


@pytest.mark.parametrize("C,F", [(512, 2044), (508, 2048), (505, 1999)])
def test_plan_takes_the_copy_path_at_conformer_l_width(C, F):
    """C % 8 or F % 8 off 0 near Conformer-L's width: no tensor map, the
    producer's element copies."""
    p = sw.swiglu_plan(6404, C, F, 64, SMS)
    _check_plan(p, 6404, F, 64)
    assert not p.aligned


@pytest.mark.parametrize("M,tm", [(6400, 128), (6401, 128), (6404, 64), (1, 64)])
def test_plan_of_the_copy_path_launches_as_the_tma_path(M, tm):
    """Unaligned tensors (the copy path) run the same grid, cluster, ring
    and shared memory as the TMA path: the producer fills the same slots."""
    C, F = (256, 1024) if tm == 128 else (512, 2048)
    p, q = sw.swiglu_plan(M, C, F, tm, SMS), sw.swiglu_plan(M, C, F, tm, SMS, aligned=False)
    _check_plan(q, M, F, tm)
    assert p.aligned and not q.aligned
    assert p._replace(aligned=False) == q


def test_plan_at_the_a_b_shapes():
    """M=6400: 50 tiles of 128 rows with F split two ways, or 100 of 64
    unsplit (100 blocks either way); M=25600 needs no split; M=3000 splits
    four ways (24 tiles), M=1 eight. The shared memory the kernel's header
    states: 230,472 bytes at either tile (a 64 KB x tile, four 32 KB
    slots, 32 KB of g tiles, nine barriers, the 1024-byte alignment)."""
    assert sw.swiglu_plan(6400, 256, 1024, 128, SMS)[:4] == (100, 2, 230_472, True)
    assert sw.swiglu_plan(6400, 256, 1024, 64, SMS)[:4] == (100, 1, 230_472, True)
    assert sw.swiglu_plan(25600, 256, 1024, 128, SMS)[:4] == (200, 1, 230_472, True)
    assert sw.swiglu_plan(3000, 256, 1024, 128, SMS)[:2] == (96, 4)
    assert sw.swiglu_plan(1, 256, 1024, 128, SMS)[:2] == (8, 8)
    assert sw.swiglu_plan(6404, 512, 2048, 64, SMS)[:4] == (101, 1, 230_472, True)


@pytest.mark.parametrize("sms,cluster", [(100, 1), (114, 2), (132, 2), (264, 4)])
def test_plan_follows_the_cards_sms(sms, cluster):
    """The cluster fills half the card it runs on: at M=6400, tm=128 (50
    tiles) a card of 100 SMs needs none, one of 264 clusters of 4."""
    assert sw.swiglu_plan(6400, 256, 1024, 128, sms).cluster == cluster


@pytest.mark.parametrize("C,F", [(256, 1024), (256, 1000), (256, 1020), (40, 70), (8, 8),
                                 (12, 64), (256, 4), (1, 1), (200, 36)])
def test_plan_takes_the_aligned_copies_exactly_where_they_fit(C, F):
    """TMA needs 16-byte row strides: C % 8 == 0 (x and w2 rows, 2C bytes)
    and F % 8 == 0 (w1 is read as (C, 2, F): a half's rows are 2F bytes
    apart); pointers the wrapper finds unaligned take the copy path too.
    An F split never outnumbers F's chunks."""
    for tm in sw.ROW_TILES:
        p = sw.swiglu_plan(6400, C, F, tm, SMS)
        assert p.aligned == (C % 8 == 0 and F % 8 == 0)
        assert not sw.swiglu_plan(6400, C, F, tm, SMS, aligned=False).aligned
        assert p.cluster <= -(-F // sw.INSTANCES[tm]["chunk"])


@pytest.mark.parametrize("M,C,F,tm,match", [(0, 8, 8, 64, "M >= 1"), (4, 520, 8, 64, "C <= 512"),
                                            (4, 257, 8, 128, "tm=128 takes C <= 256"),
                                            (4, 8, 0, 64, "F >= 1"), (4, 8, 8, 32, "tm must be")])
def test_plan_refuses_what_the_kernel_does_not_take(M, C, F, tm, match):
    with pytest.raises(ValueError, match=match):
        sw.swiglu_plan(M, C, F, tm, SMS)


def test_ab_script_by_path_needs_a_cuda_card():
    """Run by path with --root, as the parent-against-change A/B runs it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "turkish_asr_torch", "scripts",
                                                        "ab_swiglu.py"), "--root", ROOT, "64"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout == ""
