"""zfista_tpu_torch — the PyTorch/CUDA port of zfista_tpu.

Proximal-gradient methods (ISTA/FISTA with the generalized momentum
factor) in eager PyTorch, with the hot elementwise chain of dense LASSO as
a hand-written CUDA kernel for Hopper.  The JAX package :mod:`zfista_tpu`
is the reference; this package never imports JAX.

Ported so far: single-objective fixed-step solves
(``minimize_proximal_gradient`` with ``decay_rate=1``) and
:class:`zfista_tpu_torch.models.Lasso`.  See ROADMAP.md for the rest.
"""

from zfista_tpu_torch.core.options import SolverOptions
from zfista_tpu_torch.core.result import SolveResult
from zfista_tpu_torch.core.solver import minimize_proximal_gradient

__all__ = ["minimize_proximal_gradient", "SolveResult", "SolverOptions"]
