"""Tests of the port's CUDA kernels on the card.

They skip without a CUDA device. This file imports no jax (the card's
machine has none), so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states them: fp32 inputs 1e-4 absolute on
out and lse; bf16 inputs 2e-2 on out (both sides round the normalized p
to bf16, with row sums in another order) and 1e-3 on lse.
"""

import pytest
import torch

from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref
from turkish_asr_torch.ops.flash_attention import _check, flash_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(B, H, Kh, T, D, lengths, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, T, D, generator=g).to(device, dtype)
    k = torch.randn(B, Kh, T, D, generator=g).to(device, dtype)
    v = torch.randn(B, Kh, T, D, generator=g).to(device, dtype)
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]).to(device)
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Kh,T,D", [(1, 201, 64), (4, 37, 64), (1, 70, 128), (2, 9, 40)])
def test_kernel_matches_plain_version(cuda, dtype, atol, Kh, T, D):
    H = 4 if Kh != 2 else 2
    q, k, v, mask = _inputs(3, H, Kh, T, D, [T, T // 2, 0], dtype, cuda)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask)
    want_out, want_lse = flash_attention_fwd_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, rtol=0, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_kernel_without_mask_and_with_uint8_mask(cuda):
    q, k, v, mask = _inputs(2, 4, 1, 50, 64, [50, 20], torch.float32, cuda)
    out, _ = flash_attention(q, k, v, None)
    torch.testing.assert_close(out, flash_attention_fwd_ref(q, k, v, None)[0],
                               rtol=0, atol=1e-4)
    a, _ = flash_attention(q, k, v, mask)
    b, _ = flash_attention(q, k, v, mask.to(torch.uint8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _inputs(1, 4, 1, 16, 64, [16], torch.float16, cuda)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        flash_attention(q, k, v, mask)


@pytest.mark.parametrize("change,match", [
    (lambda q, k, v, m: (q.to(torch.float16), k.to(torch.float16), v.to(torch.float16), m),
     "bf16 or fp32"),
    (lambda q, k, v, m: (q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous(), m), "multiple of 8"),
    (lambda q, k, v, m: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, m),
     "contiguous"),
    (lambda q, k, v, m: (q, k, v, m[:, :5]), "mask must be"),
    (lambda q, k, v, m: (q, k.expand(1, 2, 16, 64).contiguous(),
                         v.expand(1, 2, 16, 64).contiguous(), m), "heads must be"),
    (lambda q, k, v, m: (q, k[:, :, :8], v[:, :, :8], m), "does not match"),
])
def test_wrapper_checks_inputs(change, match):
    """The checks the wrapper makes before a launch (pure shape/dtype
    logic, so they run on CPU tensors)."""
    q, k, v, mask = _inputs(1, 4, 1, 16, 64, [16], torch.float32, "cpu")
    with pytest.raises(ValueError, match=match):
        _check(*change(q, k, v, mask))
    _check(q, k, v, mask)
