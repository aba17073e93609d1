"""zfista_tpu_torch — the PyTorch/CUDA port of zfista_tpu.

Proximal-gradient methods (ISTA/FISTA with the generalized momentum
factor) in eager PyTorch, with the hot elementwise chain of dense LASSO as
a hand-written CUDA kernel for Hopper.  The JAX package :mod:`zfista_tpu`
is the reference; this package never imports JAX.

Ported so far: the single solve (``minimize_proximal_gradient``: one or
many objectives, fixed step or backtracking, every momentum option,
history, trace, host chunking and resume), the prox library
(:mod:`zfista_tpu_torch.ops.prox`), the problem zoo and
:class:`~zfista_tpu_torch.models.Lasso` (:mod:`zfista_tpu_torch.models`),
TV-regularized deblurring (:class:`~zfista_tpu_torch.models.TVDeblur`,
:func:`~zfista_tpu_torch.ops.prox_tv`), the CUDA kernels of the LASSO
step and the TV prox, and the batch solver
(:func:`zfista_tpu_torch.parallel.minimize_proximal_gradient_batch`:
many starts, λ values or momentum pairs as one lane-batched solve).  See
ROADMAP.md for what is next.
"""

from zfista_tpu_torch.core.options import SolverOptions
from zfista_tpu_torch.core.result import SolveResult
from zfista_tpu_torch.core.solver import minimize_proximal_gradient

__all__ = ["minimize_proximal_gradient", "SolveResult", "SolverOptions"]
