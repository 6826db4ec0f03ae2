"""HTTP serving: python -m turkish_asr_torch.serve.server."""
