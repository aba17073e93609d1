r"""L1-regularized logistic regression — the package's non-quadratic model.

PyTorch-port counterpart of :mod:`zfista_tpu.models.logistic`:

``min_x  (1/m) * sum_i log(1 + exp(-y_i * <a_i, x>))  +  lam * ||x||_1``

The smooth term's curvature varies over the path, so the backtracking line
search (``decay_rate < 1``, the default of :meth:`SparseLogistic.solve`)
does real work, and ``lr = 1/L`` from the global bound ``L = ||A||² / (4m)``
is pessimistic.

* The products are full-fp32 matvecs (cuBLAS on a card,
  :mod:`zfista_tpu_torch.ops.precision`).
* ``log(1 + exp(z))`` is ``torch.logaddexp(z, 0)``, exact everywhere like
  ``jax.nn.softplus``.  ``torch.nn.functional.softplus`` is not: above its
  ``threshold`` (20) it returns ``z`` itself.
* The prox is ``soft_threshold(x, w·λ)``, marked for the solver's
  fused-step seam: ``solve(decay_rate=1, lr=1/L)`` runs its step tail as
  one launch of the CUDA kernel ``lasso_step_tail``
  (:mod:`zfista_tpu_torch.ops.fused`) on a card; the backtracking solve
  launches no kernel of the port's own.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.solver import data_device, minimize_proximal_gradient
from zfista_tpu_torch.models.lasso import operator_norm_sq
from zfista_tpu_torch.ops.precision import matmul_hp, mean_hp, sum_hp
from zfista_tpu_torch.ops.prox import soft_threshold
from zfista_tpu_torch.utils.profiling import annotate, device_to_host

_DOT = matmul_hp


class SparseLogistic:
    """L1-regularized binary logistic regression (labels ``y in {-1, +1}``).

    ``A`` and ``y`` may be tensors, which keep their device (a CPU tensor
    asks for the CPU), or numpy arrays, which go to ``device`` (default
    ``"cuda"``; a machine with no card raises).  The solve runs on ``A``'s
    device.

    Instances are effectively FROZEN after construction: the solver
    operands (``A``, ``y``, ``l1_ratio``) are packed into a params tuple
    here, once; mutating the public attributes afterwards does not affect
    ``solve`` (construct a new instance instead)."""

    def __init__(self, A, y, l1_ratio: float = 0.01, device: Any = "cuda") -> None:
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(np.asarray(A), device=data_device(device))
        if not A.is_floating_point():
            # An integer A would truncate the l1_ratio scalar to 0 in the
            # params tuple (a silently unregularized solve, while g and
            # kkt_residual still use the float lambda).
            A = A.to(torch.get_default_dtype())
        self.A = A
        y = torch.as_tensor(y, device=A.device)
        if not bool(torch.all(torch.abs(y) == 1)):
            raise ValueError("labels must be -1/+1")
        self.y = y.to(A.dtype)
        self.l1_ratio = float(l1_ratio)
        self.n_samples, self.n_features = self.A.shape
        self.n_objectives = 1
        self._params = (
            self.A,
            self.y,
            torch.tensor(self.l1_ratio, dtype=A.dtype, device=A.device),
        )

    # The methods delegate to the module-level params callables below: one
    # copy of the softplus/sigmoid margin math for the solve and for the
    # kkt_residual certificate.
    def f(self, x: Array) -> Array:
        return _logistic_f_p(x, self._params)[0]

    def jac_f(self, x: Array) -> Array:
        return _logistic_jac_p(x, self._params)[0]

    def g(self, x: Array) -> Array:
        return _logistic_g_p(x, self._params)[0]

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return _logistic_prox_p(
            torch.as_tensor(weight, dtype=x.dtype, device=x.device), x, self._params
        )

    @annotate("zt.lipschitz")
    def lipschitz(self, n_iter: int = 50, generator: torch.Generator | None = None) -> float:
        """Global bound ``L = lambda_max(AᵀA) / (4 m)`` (the logistic loss's
        second derivative is at most 1/4)."""
        return float(device_to_host(
            operator_norm_sq(self.A, n_iter, generator=generator) / (4 * self.n_samples)
        ))

    def solve(self, x0=None, **kwargs):
        """Backtracking FISTA by default (the global ``1/L`` step is
        pessimistic for logistic losses; pass ``decay_rate=1, lr=1/L`` for
        the fixed-step path, which runs the fused step tail).  ``x0``
        (default zeros) takes ``A``'s dtype and device."""
        if x0 is None:
            x0 = torch.zeros(self.n_features, dtype=self.A.dtype, device=self.A.device)
        else:
            x0 = torch.as_tensor(x0, dtype=self.A.dtype, device=self.A.device)
        kwargs.setdefault("nesterov", True)
        return minimize_proximal_gradient(
            _logistic_f_p, _logistic_g_p, _logistic_jac_p, _logistic_prox_p,
            x0, params=self._params, **kwargs
        )

    def kkt_residual(self, x) -> float:
        """Max violation of the L1-subgradient optimality conditions, an
        external certificate independent of the solver's own convergence
        test: ``|grad_i| <= lam`` where ``x_i == 0`` and ``grad_i == -lam *
        sign(x_i)`` elsewhere.  Computed on the host in numpy from the
        gradient at ``x`` (any array; it takes ``A``'s dtype and device)."""
        x_t = torch.as_tensor(np.asarray(x), dtype=self.A.dtype, device=self.A.device)
        gr = self.jac_f(x_t).cpu().numpy()
        x = x_t.cpu().numpy()
        lam = self.l1_ratio
        active = x != 0
        r_active = np.abs(gr[active] + lam * np.sign(x[active]))
        r_zero = np.maximum(np.abs(gr[~active]) - lam, 0.0)
        vals = np.concatenate([r_active, r_zero])
        return float(vals.max()) if vals.size else 0.0


def _softplus(z: Array) -> Array:
    """``log(1 + exp(z))`` exactly, for every ``z`` (``jax.nn.softplus``)."""
    return torch.logaddexp(z, torch.zeros_like(z))


# Params-style callables: p = (A, y, lam).
def _logistic_f_p(x, p):
    A, y, _ = p
    margins = y * _DOT(A, x)
    return torch.reshape(mean_hp(_softplus(-margins)), (1,))


def _logistic_jac_p(x, p):
    A, y, _ = p
    margins = y * _DOT(A, x)
    coef = -torch.sigmoid(-margins) * y / A.shape[0]
    return torch.reshape(_DOT(A.T, coef), (1, -1))


def _logistic_g_p(x, p):
    lam = p[2]
    return torch.reshape(lam * sum_hp(torch.abs(x)), (1,))


def _logistic_prox_p(w, x, p):
    lam = p[2]
    w = w[0] if getattr(w, "ndim", 0) else w
    return soft_threshold(x, w * lam)


# The solver's private fused-step seam (zfista_tpu_torch.core.solver): this
# prox is soft_threshold(x, w * p[2]), so the fixed-step nesterov step may
# compute it and the momentum extrapolation in one fused kernel launch.
_logistic_prox_p._soft_threshold_lam_of = lambda p: p[2]
