r"""LASSO / elastic-net: the framework's flagship workload.

PyTorch-port counterpart of :mod:`zfista_tpu.models.lasso`:
``min_x ||A x - b||² + λ‖x‖₁ (+ (μ/2)‖x‖²)`` with dense ``A (m, n)``.

* ``f``/``jac_f`` are two dense matvecs in full fp32 (cuBLAS on a card,
  :mod:`zfista_tpu_torch.ops.precision`).
* ``prox`` is the closed-form soft-threshold.  On the fixed-step solve the
  solver runs it, together with the momentum extrapolation, as one launch
  of the fused CUDA kernel (:mod:`zfista_tpu_torch.ops.fused`).

The Lipschitz constant of ``∇f`` is ``2·λ_max(AᵀA)``, estimated by power
iteration (matvec-only).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.solver import data_device, minimize_proximal_gradient
from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.ops.precision import dot_hp, matmul_hp
from zfista_tpu_torch.ops.prox import prox_group_lasso, soft_threshold

_DOT = matmul_hp


def operator_norm_sq(
    A: Array, n_iter: int = 50, generator: torch.Generator | None = None
) -> Array:
    """λ_max(AᵀA) by power iteration on v ↦ Aᵀ(A v) (matvec-only).

    The start vector is drawn from ``generator`` (default: a fresh one on
    ``A``'s device seeded with 0).  It cannot reproduce the JAX package's
    ``PRNGKey`` bits, so the two packages' estimates agree only to the
    power iteration's accuracy.
    """
    if generator is None:
        generator = torch.Generator(device=A.device).manual_seed(0)
    v = torch.randn(
        A.shape[1], generator=generator, dtype=A.dtype, device=A.device
    )
    v = v / torch.linalg.vector_norm(v)
    for _ in range(n_iter):
        w = _DOT(A.T, _DOT(A, v))
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    w = _DOT(A.T, _DOT(A, v))
    return dot_hp(v, w)


class Lasso(Problem):
    r"""``F(x) = ||A x - b||² + λ‖x‖₁ + (μ/2)‖x‖²`` (elastic net for μ>0).

    Matches the reference's test formulation ``f = ||Ax-b||²`` (no 1/2),
    so ``∇f = 2 Aᵀ(Ax−b)`` and ``L = 2 λ_max(AᵀA)``.

    ``A`` and ``b`` may be tensors, which keep their device (a CPU tensor
    asks for the CPU), or numpy arrays, which go to ``device`` (default
    ``"cuda"``; a machine with no card raises).  The solve runs on ``A``'s
    device.
    """

    def __init__(
        self, A, b, l1_ratio: float, l2_ratio: float = 0.0, device: Any = "cuda"
    ) -> None:
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(np.asarray(A), device=data_device(device))
        if not A.is_floating_point():
            # An integer A would truncate the λ/μ scalars packed with it
            # into the params tuple (a silently unregularized solve).
            A = A.to(torch.get_default_dtype())
        self.A = A
        self.b = torch.as_tensor(b, dtype=A.dtype, device=A.device)
        self.l1_ratio = float(l1_ratio)
        self.l2_ratio = float(l2_ratio)
        super().__init__(
            n_features=self.A.shape[1],
            n_objectives=1,
            l1_ratios=[l1_ratio],
        )

    def f(self, x: Array) -> Array:
        r = _DOT(self.A, x) - self.b
        val = dot_hp(r, r)
        if self.l2_ratio:
            val = val + 0.5 * self.l2_ratio * dot_hp(x, x)
        return torch.reshape(val, (1,))

    def jac_f(self, x: Array) -> Array:
        grad = 2 * _DOT(self.A.T, _DOT(self.A, x) - self.b)
        if self.l2_ratio:
            grad = grad + self.l2_ratio * x
        return torch.reshape(grad, (1, -1))

    def g(self, x: Array) -> Array:
        return torch.reshape(self.l1_ratio * torch.sum(torch.abs(x)), (1,))

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return soft_threshold(x, weight * self.l1_ratio)

    def lipschitz(
        self, n_iter: int = 50, generator: torch.Generator | None = None
    ) -> float:
        """``L = 2 λ_max(AᵀA) (+ μ)`` — use ``lr = 1/L`` with
        ``decay_rate=1`` for the fixed-step fast path."""
        return float(2 * operator_norm_sq(self.A, n_iter, generator) + self.l2_ratio)

    def minimize_proximal_gradient(self, x0, **kwargs):
        """Solve from ``x0``, cast to ``A``'s dtype and moved to its device."""
        x0 = torch.as_tensor(x0, dtype=self.A.dtype, device=self.A.device)
        return super().minimize_proximal_gradient(x0, **kwargs)

    solve = minimize_proximal_gradient

    def solve_batch(self, x0s, **kwargs):
        """Solve from every row of ``x0s``, cast to ``A``'s dtype and moved
        to its device, as one lane-batched solve."""
        x0s = torch.as_tensor(x0s, dtype=self.A.dtype, device=self.A.device)
        return super().solve_batch(x0s, **kwargs)

    def solve_fixed_step(self, x0, **kwargs):
        """Fixed-step FISTA at ``lr = 1/L`` (no backtracking) — the
        bandwidth-bound hot path.

        ``A``/``b``/``lambda``/``mu`` ride through the solver's ``params``
        argument, and the params-style prox lets the solver's step run the
        soft-threshold and the momentum extrapolation as one fused kernel
        launch.  ``x0`` is cast to ``A``'s dtype and moved to its device
        (PyTorch does not promote mixed-dtype matmuls).

        .. warning:: The instance is FROZEN after the first call: the
           params tuple and ``1/L`` are cached, so later mutation of
           ``A``/``b``/``l1_ratio``/``l2_ratio`` attributes is silently
           ignored.  Build a new instance per problem.
        """
        if "lr" not in kwargs:
            # Cache 1/L: the 50-matvec power iteration is the dominant
            # per-call cost for repeat solves on a fixed operator.
            lr = getattr(self, "_lr_cache", None)
            if lr is None:
                lr = self._lr_cache = 1.0 / self.lipschitz()
            kwargs["lr"] = lr
        kwargs.setdefault("decay_rate", 1)
        kwargs.setdefault("nesterov", True)
        p = getattr(self, "_params_cache", None)
        if p is None:
            dt, dev = self.A.dtype, self.A.device
            p = (self.A, self.b, torch.tensor(self.l1_ratio, dtype=dt, device=dev))
            if self.l2_ratio:
                p = p + (torch.tensor(self.l2_ratio, dtype=dt, device=dev),)
            self._params_cache = p
        x0 = torch.as_tensor(x0, dtype=self.A.dtype, device=self.A.device)
        return minimize_proximal_gradient(
            _lasso_f_p, _lasso_g_p, _lasso_jac_p, _lasso_prox_p, x0,
            params=p, **kwargs
        )


# Module-level params-style callables for Lasso.solve_fixed_step, with all
# operand data — A, b, lambda (and mu for elastic net) — in the params
# tuple ``p = (A, b, lam[, l2])``.  Pure-LASSO solves omit l2 and pay
# nothing for the elastic-net terms.
def _lasso_f_p(x, p):
    A, b = p[:2]
    r = _DOT(A, x) - b
    val = dot_hp(r, r)
    if len(p) > 3:
        val = val + 0.5 * p[3] * dot_hp(x, x)
    return torch.reshape(val, (1,))


def _lasso_jac_p(x, p):
    A, b = p[:2]
    grad = 2 * _DOT(A.T, _DOT(A, x) - b)
    if len(p) > 3:
        grad = grad + p[3] * x
    return torch.reshape(grad, (1, -1))


def _lasso_g_p(x, p):
    lam = p[2]
    return torch.reshape(lam * torch.sum(torch.abs(x)), (1,))


def _lasso_prox_p(w, x, p):
    lam = p[2]
    w = w[0] if getattr(w, "ndim", 0) else w
    return soft_threshold(x, w * lam)


# The solver's private fused-step seam (zfista_tpu_torch.core.solver): this
# prox is soft_threshold(x, w * p[2]), so the fixed-step nesterov step may
# compute it and the momentum extrapolation in one fused kernel launch.
_lasso_prox_p._soft_threshold_lam_of = lambda p: p[2]


def _operands(A, b, device: Any) -> tuple[Array, Array]:
    """``A`` and ``b`` as tensors: tensors keep their device, numpy goes to
    ``device``; ``b`` takes ``A``'s dtype."""
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A), device=data_device(device))
    return A, torch.as_tensor(b, dtype=A.dtype, device=A.device)


def make_lasso_lambda_sweep(A, b, l2_ratio: float = 0.0, device: Any = "cuda"):
    """Problem callables with a per-lane λ for
    :func:`zfista_tpu_torch.parallel.minimize_proximal_gradient_batch`
    (BASELINE configs[2]: the 1k-λ elastic-net sweep as one batched solve).

    ``l2_ratio`` (μ, shared by every lane) adds the elastic-net term
    ``(μ/2)‖x‖²`` with the convention of :class:`Lasso`; 0 is the pure
    LASSO sweep.  ``A`` and ``b`` may be tensors, which keep their device,
    or numpy arrays, which go to ``device`` (default ``"cuda"``; a machine
    with no card raises).  Over the lanes the two products are GEMMs
    through :func:`~zfista_tpu_torch.ops.precision.matmul_hp` (full fp32).
    Returns ``(f, g, jac_f, prox)``, each taking λ last; pass λ in ``A``'s
    dtype.
    """
    A, b = _operands(A, b, device)
    mu = float(l2_ratio)

    def f(x, lam):
        r = _DOT(A, x) - b
        val = dot_hp(r, r)
        if mu:
            val = val + 0.5 * mu * dot_hp(x, x)
        return torch.reshape(val, (1,))

    def jac_f(x, lam):
        grad = 2 * _DOT(A.T, _DOT(A, x) - b)
        if mu:
            grad = grad + mu * x
        return torch.reshape(grad, (1, -1))

    def g(x, lam):
        return torch.reshape(lam * torch.sum(torch.abs(x)), (1,))

    def prox(weight, x, lam):
        w = weight[0] if getattr(weight, "ndim", 0) else weight
        return soft_threshold(x, w * lam)

    return f, g, jac_f, prox


def make_group_lasso_lambda_sweep(A, b, group_size: int, device: Any = "cuda"):
    """Per-lane-λ group-lasso callables for the batch solver (the
    group-lasso half of the sweep config; block soft-threshold prox).
    ``A`` and ``b`` as in :func:`make_lasso_lambda_sweep`.  Returns ``(f,
    g, jac_f, prox)``, each taking λ last.
    """
    A, b = _operands(A, b, device)
    gs = int(group_size)
    if A.shape[1] % gs:
        raise ValueError("n_features must divide by group_size")

    def f(x, lam):
        r = _DOT(A, x) - b
        return torch.reshape(dot_hp(r, r), (1,))

    def jac_f(x, lam):
        return torch.reshape(2 * _DOT(A.T, _DOT(A, x) - b), (1, -1))

    def g(x, lam):
        v = x.reshape(-1, gs)
        return torch.reshape(lam * torch.sum(torch.sqrt(torch.sum(v * v, dim=-1))), (1,))

    def prox(weight, x, lam):
        w = weight[0] if getattr(weight, "ndim", 0) else weight
        return prox_group_lasso(x, w * lam, gs)

    return f, g, jac_f, prox


def fista_step_dense(A: Array, b: Array, lam: Array, lr: Array, carry):
    """One fixed-step FISTA iteration on dense LASSO, written as a plain
    function ``carry=(x, y, t) -> carry`` — the unfused step that
    :func:`zfista_tpu_torch.ops.fused.fista_step_dense_fused` replaces.
    ``t`` is a 0-d tensor.
    """
    x, y, t = carry
    grad = 2 * _DOT(A.T, _DOT(A, y) - b)
    x_new = soft_threshold(y - lr * grad, lr * lam)
    t_new = torch.sqrt(t * t + 0.25) + 0.5
    y_new = x_new + ((t - 1) / t_new) * (x_new - x)
    return x_new, y_new, t_new
