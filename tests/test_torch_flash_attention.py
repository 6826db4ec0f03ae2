"""The flash-attention kernel's plain PyTorch version against the JAX
Pallas kernel (run in interpret mode on the CPU, as
tests/test_flash_attention.py runs it), and the wrapper's CPU dispatch.

Tolerance 1e-5 absolute on out and lse: both sides compute fp32 scores,
an fp32 softmax and an fp32 p @ v from the same fp32 inputs; only the
order of the sums differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turkish_asr_tpu.ops._flash_attention_impl import _flash_attention_fwd_impl
from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref
from turkish_asr_torch.ops.flash_attention import flash_attention

ATOL = 1e-5


def _inputs(B, H, Kh, T, D, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Kh, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Kh, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def _jax_fwd(q, k, v, mask, block_q):
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_attention_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            jnp.zeros((1,), jnp.int32), block_q, 0.0)
    B, H, T, _ = q.shape
    # MQA lse is (B, 1, H*T), MHA lse is (B, H, 1, T): both are (B, H, T).
    return np.asarray(out), np.asarray(lse).reshape(B, H, T)


@pytest.mark.parametrize("Kh", [1, 4])
@pytest.mark.parametrize("T,lengths,block_q", [
    (37, [37, 20, 0], 64),    # partial last tile, ragged mask, a length-0 row
    (64, [64, 64, 1], 32),    # whole tiles, a length-1 row
])
def test_plain_version_matches_jax_kernel(Kh, T, lengths, block_q):
    B, H, D = len(lengths), 4, 32
    q, k, v, mask = _inputs(B, H, Kh, T, D, lengths, seed=T + Kh)
    want_out, want_lse = _jax_fwd(q, k, v, mask, block_q)
    out, lse = flash_attention_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (B, H, T, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)


def test_length_zero_row_is_uniform_and_finite():
    q, k, v, mask = _inputs(2, 4, 1, 16, 8, [16, 0], seed=5)
    out, lse = flash_attention_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(mask))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # No valid key: every key weighs 1/T, so each head's context is mean(v).
    want = np.broadcast_to(v[1, 0].mean(axis=0), out[1].shape)
    np.testing.assert_allclose(out[1].numpy(), want, atol=ATOL)


def test_wrapper_takes_plain_path_on_cpu():
    q, k, v, mask = _inputs(2, 4, 1, 24, 16, [24, 10], seed=6)
    flash_attention.launches = 0
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    out, lse = flash_attention(*args)
    want_out, want_lse = flash_attention_fwd_ref(*args)
    assert flash_attention.launches == 0
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_plain_version_without_mask_equals_all_valid():
    q, k, v, mask = _inputs(1, 2, 2, 20, 8, [20], seed=7)
    a = flash_attention_fwd_ref(*(torch.from_numpy(x) for x in (q, k, v)), None)
    b = flash_attention_fwd_ref(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
