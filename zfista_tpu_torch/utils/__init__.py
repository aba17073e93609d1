"""Utility subsystems (PyTorch port): checkpoint/resume, tracing helpers."""

__all__ = ["save_state", "load_state"]


def __getattr__(name: str):
    # Imported on first use: the checkpoint module imports the solver, which
    # imports this package's tracing module.
    if name in __all__:
        from zfista_tpu_torch.utils import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
