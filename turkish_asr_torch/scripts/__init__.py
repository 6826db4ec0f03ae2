"""Entry points that are not the model's: ``python -m turkish_asr_torch.scripts.<name>``."""
