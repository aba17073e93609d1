r"""Solvers for the proximal subproblem of one outer iteration.

PyTorch-port counterpart of :mod:`zfista_tpu.core.subproblem`.  At each
outer iteration the method solves

.. math::

    \min_x \; \max_i \big[ \nabla f_i(y)^\top (x - y) + g_i(x)
        + f_i(y) - F_i(x_{old}) \big] + \tfrac{1}{2\,lr}\|x - y\|^2 .

With one objective (``m == 1``) that is a single closed-form prox step,
ported here.  The multiobjective duals (``m == 2`` bisection, ``m >= 3``
semismooth Newton) are ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.ops.precision import dot_hp

_VDOT = dot_hp


class SubproblemResult(NamedTuple):
    x: Array  # (n,) primal solution
    fun: Array | None  # scalar primal subproblem value (None: not asked for)
    weight: Array  # (m,) dual solution
    nit: int  # inner iterations used


def make_subproblem_solver(
    g: Callable[[Array], Array],
    prox_wsum_g: Callable[[Array, Array], Array],
    n_objectives: int,
    *,
    tol: float,
    max_iter: int,
    deprecated: bool = False,
) -> Callable[..., SubproblemResult]:
    """Build ``solve(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult``.

    ``tol`` and ``max_iter`` bound the multiobjective dual solvers, which
    are not ported yet; the closed-form ``m == 1`` solve uses neither.
    """
    m = n_objectives
    if m != 1:
        raise NotImplementedError(
            f"{m} objectives: the multiobjective subproblem duals are not "
            "ported yet (ROADMAP.md Queue 1 item 5); zfista_tpu_torch solves "
            "m == 1 problems"
        )

    def solve_scalar(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult:
        """One prox step.  ``f_y=None`` skips the model value ``fun``: the
        fixed-step solver never reads it, and eager PyTorch has no dead-code
        elimination to drop it as XLA does in the JAX step."""
        grad = jac_f_y[0]
        ones = torch.ones((1,), dtype=y.dtype, device=y.device)
        x = prox_wsum_g(lr * ones, y - lr * grad)
        fun = None
        if f_y is not None:
            d = x - y
            fun = _VDOT(grad, d) + g(x)[0] + _VDOT(d, d) / (2 * lr)
            if not deprecated:
                fun = fun + (f_y[0] - F_old[0])
        return SubproblemResult(
            x=x,
            fun=fun,
            weight=ones,
            nit=1,
        )

    return solve_scalar
