"""Utility subsystems (PyTorch port): checkpoint/resume, tracing helpers."""

from zfista_tpu_torch.utils.checkpoint import load_state, save_state

__all__ = ["save_state", "load_state"]
