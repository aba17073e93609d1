"""Core proximal-gradient solver (PyTorch port)."""

from zfista_tpu_torch.core.result import SolveResult
from zfista_tpu_torch.core.solver import minimize_proximal_gradient

__all__ = ["minimize_proximal_gradient", "SolveResult"]
