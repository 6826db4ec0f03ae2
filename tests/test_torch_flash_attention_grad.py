"""Gradients of the port's flash attention (ops/flash_attention.py: the
autograd Function, with the plain backward on the CPU) and its attention
dropout, against autograd of the plain forward, against ``jax.grad`` of
the JAX package's Pallas kernel in interpret mode, and, with dropout on,
against ``jax.grad`` of an explicit JAX softmax attention fed the port's
keep mask. The TPU kernel's own dropout bits cannot serve as an oracle:
interpret mode returns all-zero bits (tests/test_flash_attention.py).

Tolerances: 1e-4 absolute against autograd of the plain forward (the
same fp32 math in another order of operations); 1e-3 relative and
absolute against JAX, as tests/test_flash_attention_grad.py holds the JAX
kernel against its einsum path.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_torch.ops._dropout import fmix32, keep_mask_ref, keep_rows_ref, keep_threshold
from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref
from turkish_asr_torch.ops.flash_attention import dump_keep_mask, flash_attention

B, H, D = 3, 4, 32


def _inputs(Kh, T, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Kh, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Kh, T, D)).astype(np.float32)
    g = rng.standard_normal((B, H, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, g, mask


def _port_grads(q, k, v, g, mask, rate=0.0, seed=0):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, _ = flash_attention(qt, kt, vt, torch.from_numpy(mask), rate, seed)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("Kh,T", [(1, 40), (4, 40), (1, 64), (4, 17)])
def test_plain_backward_matches_autograd_of_plain_forward(Kh, T, rate):
    """Every row weighted, the length-0 row (third sample) included: its
    uniform forward weights must get finite, matching gradients."""
    q, k, v, g, mask = _inputs(Kh, T, [T, 33 % T + 1, 0])
    out, got = _port_grads(q, k, v, g, mask, rate, seed=7)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    want_out, _ = flash_attention_fwd_ref(qt, kt, vt, torch.from_numpy(mask), rate, 7)
    (want_out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out, want_out.detach().numpy(), rtol=0, atol=1e-5)
    for a, t in zip(got, (qt, kt, vt)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, t.grad.numpy(), rtol=0, atol=1e-4)
    assert np.abs(got[2][2]).max() > 0  # the length-0 sample's dv is not zero


@pytest.mark.parametrize("Kh", [1, 4])
@pytest.mark.parametrize("T", [64, 40])
def test_grads_match_jax_kernel(Kh, T):
    """As tests/test_flash_attention_grad.py: only valid query rows carry a
    cotangent (the JAX kernel's length-0 rows take exp(s - lse) with an lse
    that rounds to -1e9, so their gradient is not the softmax's)."""
    from jax.experimental.pallas import tpu as pltpu
    from turkish_asr_tpu.ops._flash_attention_impl import flash_attention as jax_flash

    q, k, v, g, mask = _inputs(Kh, T, [T, 33, 0])
    g = g * mask[:, None, :, None]

    def loss(a, b, c):
        return jnp.sum(jax_flash(a, b, c, jnp.asarray(mask), block_q=64) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, got = _port_grads(q, k, v, g, mask)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("Kh", [1, 4])
def test_dropout_matches_explicit_jax_attention(Kh):
    """The port's forward and gradients with dropout 0.1 against jax.grad
    of softmax(q k^T / sqrt(D) - 1e9 (1 - mask)) * m / (1 - rate) @ v, with
    m the port's keep mask."""
    T, rate, seed = 24, 0.1, 1234
    q, k, v, g, mask = _inputs(Kh, T, [T, 11, 5])
    keep = keep_mask_ref(seed, B, H, T, rate).numpy()

    def attend(a, b, c):
        b = jnp.broadcast_to(b, (B, H, T, D))
        c = jnp.broadcast_to(c, (B, H, T, D))
        s = jnp.einsum("bhtd,bhsd->bhts", a, b) / math.sqrt(D)
        s = s + (jnp.asarray(mask, jnp.float32)[:, None, None, :] - 1.0) * 1e9
        p = jax.nn.softmax(s, -1)
        p = jnp.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        return jnp.einsum("bhts,bhsd->bhtd", p, c)

    want_out = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = jax.grad(lambda a, b, c: jnp.sum(attend(a, b, c) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, got = _port_grads(q, k, v, g, mask, rate, seed)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=1e-3, atol=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-3)


def test_keep_rate_is_one_minus_rate():
    """Over 2 x 4 x 96 x 96 draws the kept share lies within 5 sigma of
    1 - rate for each rate."""
    for rate in (0.1, 0.5):
        keep = keep_mask_ref(99, 2, 4, 96, rate)
        n = keep.numel()
        sigma = math.sqrt(rate * (1 - rate) / n)
        assert abs(keep.float().mean().item() - (1 - rate)) < 5 * sigma


def test_masks_differ_across_seeds_samples_heads_and_rows():
    keep = keep_mask_ref(5, 2, 2, 64, 0.5)
    other = keep_mask_ref(6, 2, 2, 64, 0.5)
    for a, b in ((keep, other), (keep[0], keep[1]), (keep[:, 0], keep[:, 1]),
                 (keep[:, :, 0], keep[:, :, 1])):
        assert 0.35 < (a != b).float().mean().item() < 0.65


def test_rate_zero_is_no_dropout():
    q, k, v, g, mask = _inputs(1, 40, [40, 20, 0])
    a = _port_grads(q, k, v, g, mask)
    b = _port_grads(q, k, v, g, mask, 0.0, seed=12345)
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert keep_mask_ref(3, 1, 2, 8, 0.0).all()


def test_hash_matches_32bit_integer_arithmetic():
    """The int64 version of the hash against the same hash in Python's
    unbounded integers masked to 32 bits, as the CUDA code computes it."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    seed, Bn, Hn, T, rate = 0xDEADBEEF, 2, 3, 5, 0.3
    keep = keep_mask_ref(seed, Bn, Hn, T, rate)
    for b in range(Bn):
        for h in range(Hn):
            stream = fmix(seed ^ (((b * Hn + h + 1) * 0x9E3779B1) & 0xFFFFFFFF))
            for t in range(T):
                row = fmix(stream ^ (((t + 1) * 0x85EBCA77) & 0xFFFFFFFF))
                for j in range(T):
                    bits = fmix(row ^ (((j + 1) * 0xC2B2AE3D) & 0xFFFFFFFF))
                    assert keep[b, h, t, j].item() == (bits >= keep_threshold(rate))
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x12345678])
    assert fmix32(x).tolist() == [fmix(int(i)) for i in x]


def test_dump_keep_mask_on_cpu_is_the_plain_hash():
    np.testing.assert_array_equal(dump_keep_mask(2, 3, 10, 77, 0.2, "cpu").numpy(),
                                  keep_mask_ref(77, 2, 3, 10, 0.2).numpy())
    with pytest.raises(ValueError, match="dropout_rate"):
        dump_keep_mask(1, 1, 4, 0, 1.0, "cpu")
    with pytest.raises(ValueError, match="seed"):
        flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                        torch.zeros(1, 1, 4, 8), None, 0.1, -1)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 33])
def test_keep_rows_ref_is_keep_mask_refs_rows(T):
    """The plain hash of a few rows, for dumps too large to rebuild whole,
    against the same rows of the whole mask (B=3, H=3)."""
    whole = keep_mask_ref(0xBEEF, 3, 3, T, 0.3)
    rows = sorted({0, T // 2, T - 1})
    for b in range(3):
        for h in range(3):
            got = keep_rows_ref(0xBEEF, b, 3, h, rows, T, 0.3)
            assert got.shape == (len(rows), T) and got.dtype == torch.bool
            assert torch.equal(got, whole[b, h, rows])
