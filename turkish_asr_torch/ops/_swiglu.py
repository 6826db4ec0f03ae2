"""Plain PyTorch versions of the fused SwiGLU FFN forward.

Counterparts of scripts/ab_swiglu.py: ``swiglu_fused_ref`` computes what
the Pallas kernel ``_kernel`` (:56-64) computes, and ``swiglu_chain``
what the matmul chain ``swiglu_xla`` (:46-53) computes. Both take
x (M, C) bf16, w1 (C, 2F) bf16, b1 (2F,) or (1, 2F) fp32, w2 (F, C) bf16
and b2 (C,) or (1, C) fp32, and return y (M, C) bf16. Neither is the
model's ``swiglu_ffn`` (turkish_asr_tpu/models/conformer.py:187), which
rounds h to the compute dtype before the gate.

``swiglu_fused_ref`` is the CPU path of ``ops/swiglu.py::swiglu`` and the
value the CUDA kernel is held to. Its products widen bf16 to fp32, whose
products of bf16 values are exact, so only the summation order differs
from the kernel; a caller on the card turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) to keep them fp32.
"""

import torch


def swiglu_fused_ref(x, w1, b1, w2, b2):
    """h = x @ w1 + b1 in fp32; g = bf16(h1 * sigmoid(h1) * h2) in fp32;
    y = bf16(g @ w2 + b2) with an fp32 product."""
    h = x.float() @ w1.float() + b1.float().reshape(-1)
    f = h.shape[-1] // 2
    h1, h2 = h[:, :f], h[:, f:]
    g = (h1 * torch.sigmoid(h1) * h2).to(torch.bfloat16)
    return (g.float() @ w2.float() + b2.float().reshape(-1)).to(torch.bfloat16)


def _product(a, b):
    """a @ b of bf16 matrices with fp32 sums and an fp32 result, as
    ``jnp.dot(..., preferred_element_type=jnp.float32)``: cuBLAS's bf16
    GEMM on the card; on the CPU, which has no bf16 -> fp32 mm, the
    widened fp32 product, whose terms are exact."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def swiglu_chain(x, w1, b1, w2, b2):
    """The matmul chain: h = bf16(x @ w1 + b1); g = bf16(silu(h1) in fp32)
    * h2 in bf16; y = bf16(g @ w2 + b2), both products with fp32 sums."""
    h = (_product(x, w1) + b1.float().reshape(-1)).to(torch.bfloat16)
    f = h.shape[-1] // 2
    g = torch.nn.functional.silu(h[:, :f].float()).to(torch.bfloat16) * h[:, f:]
    return (_product(g, w2) + b2.float().reshape(-1)).to(torch.bfloat16)
