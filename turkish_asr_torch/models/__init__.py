"""The Conformer-CTC model: RoPE + multi-query attention, conv module, blocks."""
