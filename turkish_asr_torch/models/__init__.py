"""The Conformer-CTC model: RoPE + multi-query attention, conv module, blocks.

The JAX package's functional ``apply_model``, ``mqa_attention`` and
``init_attention`` have no counterpart: the port's modules hold their
weights and run in ``forward``."""

from turkish_asr_torch.models.attention import (
    MultiQueryAttention,
    RotaryEmbedding,
    apply_rope,
    rope_cos_sin,
    rotate_half,
)
from turkish_asr_torch.models.conformer import (
    ConformerBlock,
    ConformerCTC,
    ModelConfig,
    count_params,
    init_model,
)

__all__ = [
    "ModelConfig",
    "init_model",
    "count_params",
    "rope_cos_sin",
    "rotate_half",
    "apply_rope",
    "ConformerCTC",
    "ConformerBlock",
    "MultiQueryAttention",
    "RotaryEmbedding",
]
