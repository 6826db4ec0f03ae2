"""HTTP serving: python -m turkish_asr_torch.serve.server."""

__all__ = [
    "ServerConfig",
    "ASRService",
    "run_server",
]


def __getattr__(name):
    # Imported at first use: the server module is also run as ``python -m
    # turkish_asr_torch.serve.server``, and runpy warns when the package has
    # imported the module it is about to run.
    if name in __all__:
        from turkish_asr_torch.serve import server
        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
