r"""LASSO / elastic-net: the framework's flagship workload, and group LASSO.

PyTorch-port counterpart of :mod:`zfista_tpu.models.lasso`:
``min_x ||A x - b||² + λ‖x‖₁ (+ (μ/2)‖x‖²)`` with dense ``A (m, n)``, and
``GroupLasso`` with ``λ Σ_g ||x_g||₂`` in place of the ℓ1 term.

* ``f`` is a dense matvec in full fp32 (cuBLAS on a card,
  :mod:`zfista_tpu_torch.ops.precision`); ``jac_f`` is two, except where
  :func:`_normal_grad` takes the single-pass kernel that reads ``A`` once
  (:func:`~zfista_tpu_torch.ops.fused.lasso_normal_gemv`).
* ``prox`` is the closed-form soft-threshold.  On the fixed-step solve the
  solver runs it, together with the momentum extrapolation, as one launch
  of the fused CUDA kernel (:mod:`zfista_tpu_torch.ops.fused`).

The Lipschitz constant of ``∇f`` is ``2·λ_max(AᵀA)``, estimated by power
iteration (matvec-only).

Feature sharding (the JAX package's GSPMD ``P(None, "model")`` operator):
``Lasso``, its params callables, :func:`operator_norm_sq` and
:func:`fista_step_dense` take ``A`` as this rank's column block, laid out
by :func:`~zfista_tpu_torch.parallel.sharding.operator_sharding`, and ``x``
as the matching feature block.  ``A_loc @ x_loc`` is all-reduced over the
``"model"`` ranks, so the residual ``r`` (``m`` is small) is whole on every
rank; ``Aᵀ r`` and the prox are local, and every sum over features (the ℓ1
and ℓ2 terms, the power iteration's norms) is all-reduced.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.solver import data_device, minimize_proximal_gradient
from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.ops import fused
from zfista_tpu_torch.ops.precision import dot_hp, lane_sum, matmul_hp, sum_hp
from zfista_tpu_torch.ops.prox import shrink_groups, soft_threshold
from zfista_tpu_torch.parallel.sharding import (
    all_reduce_sum,
    block,
    feature_sharding,
    feature_sum,
    lanes_on_operator,
    mark_operator,
    sharding_of,
    tag,
)
from zfista_tpu_torch.utils.profiling import annotate, device_to_host

_DOT = matmul_hp


def _one_pass(A: Array, b: Array, x: Array) -> bool:
    """Whether :func:`_normal_grad` takes the single-pass kernel: for a
    whole operator (not a feature-sharded one's column block) whose
    operands the kernel takes
    (:func:`~zfista_tpu_torch.ops.fused.normal_gemv_takes`: a row-major
    float32 ``A`` on a card, rows no wider than the kernel's, nothing
    batched by ``vmap`` or tracked for a gradient)."""
    return sharding_of(A) is None and fused.normal_gemv_takes(A, b, x)


def _normal_grad(A: Array, b: Array, x: Array) -> Array:
    """``2·Aᵀ(A x − b)``, the gradient of ``‖A x − b‖²``: one read of ``A``
    by the single-pass kernel where :func:`_one_pass` allows it, else two
    full-fp32 products, ``A x`` all-reduced over a feature-sharded ``A``'s
    ranks."""
    if _one_pass(A, b, x):
        return fused.lasso_normal_gemv(A, b, x)
    return 2 * _DOT(A.T, feature_sum(A, _DOT(A, x)) - b)


def _operator(A: Array) -> Array:
    """``A`` as a LASSO operator: whole, or a column block laid out by
    ``operator_sharding`` (which keeps its tag)."""
    sh = sharding_of(A)
    if not A.is_floating_point():
        # An integer A would truncate the λ/μ scalars packed with it
        # into the params tuple (a silently unregularized solve).
        A = A.to(torch.get_default_dtype())
        if sh is not None:
            tag(A, sh)
    if sh is not None and (sh.dim, sh.axis) != ("model", 1):
        raise ValueError(
            f"a LASSO operator is whole or laid out by operator_sharding "
            f"(P(None, 'model')); got {sh.spec!r}"
        )
    return A


def operator_norm_sq(
    A: Array,
    n_iter: int = 50,
    seed: int | torch.Generator = 0,
    *,
    generator: torch.Generator | None = None,
) -> Array:
    """λ_max(AᵀA) by power iteration on v ↦ Aᵀ(A v) (matvec-only).

    The JAX package's signature: the start vector is drawn from a fresh
    generator on ``A``'s device seeded with ``seed``, or from
    ``generator`` when one is given (a ``torch.Generator`` in ``seed``'s
    place counts as one).  It cannot reproduce the JAX package's
    ``PRNGKey`` bits, so the two packages' estimates agree only to the
    power iteration's accuracy.  A column block of a feature-sharded ``A``
    draws the whole start vector and keeps its block, so the estimate is
    the unsharded one to rounding.
    """
    if generator is None:
        if isinstance(seed, torch.Generator):
            generator = seed
        else:
            generator = torch.Generator(device=A.device).manual_seed(int(seed))
    sh = sharding_of(A)
    k = 1 if sh is None else sh.mesh.size("model")
    v = torch.randn(
        A.shape[1] * k, generator=generator, dtype=A.dtype, device=A.device
    )
    if sh is not None:
        v = block(v, feature_sharding(sh.mesh))

    def norm(u):
        if sh is None or sh.group is None:
            return torch.linalg.vector_norm(u)
        return torch.sqrt(all_reduce_sum(dot_hp(u, u), sh.group))

    def normal(u):
        return _DOT(A.T, feature_sum(A, _DOT(A, u)))

    v = v / norm(v)
    for _ in range(n_iter):
        w = normal(v)
        v = w / torch.clamp_min(norm(w), 1e-30)
    return feature_sum(A, dot_hp(v, normal(v)))


class _OnOperator(Problem):
    """A problem on a dense operator ``A``: its solves start from ``x0``
    cast to ``A``'s dtype and moved to its device."""

    def _start(self, x0) -> Array:
        """``x0`` cast to ``A``'s dtype on its device; with a feature-sharded
        ``A``, this rank's feature block of it (``x0`` whole, or already the
        block), tagged with the placement the solver reads."""
        x = torch.as_tensor(x0, dtype=self.A.dtype, device=self.A.device)
        sh = sharding_of(self.A)
        if sh is None:
            return x
        fsh = feature_sharding(sh.mesh)
        if sharding_of(x0) is None:
            x = block(x, fsh)
        if x.shape != (self.A.shape[1],):
            raise ValueError(
                f"x0 of shape {tuple(x.shape)} is not the feature block "
                f"({self.A.shape[1]},) of this rank"
            )
        return tag(x.view(x.shape), fsh)

    def minimize_proximal_gradient(self, x0, **kwargs):
        """Solve from ``x0``, cast to ``A``'s dtype and moved to its device
        (feature-sharded ``A``: this rank's block of ``x0``, the whole
        result on every rank)."""
        return super().minimize_proximal_gradient(self._start(x0), **kwargs)

    solve = minimize_proximal_gradient

    def solve_batch(self, x0s, **kwargs):
        """Solve from every row of ``x0s``, cast to ``A``'s dtype and moved
        to its device, as one lane-batched solve.  With a feature-sharded
        ``A`` the lanes lie on its mesh as ``P("batch", "model")``: over
        the ``"batch"`` ranks and, within a lane, by features over the
        ``"model"`` ranks (``x0s`` whole, or this rank's block of it); the
        whole batch returns on every rank."""
        x0s_t = torch.as_tensor(x0s, dtype=self.A.dtype, device=self.A.device)
        sh = sharding_of(self.A)
        if sh is not None:
            kwargs["in_sharding"] = lanes_on_operator(sh, kwargs.get("in_sharding"))
            if sharding_of(x0s) is not None:
                tag(x0s_t, sharding_of(x0s))
        return super().solve_batch(x0s_t, **kwargs)


class Lasso(_OnOperator):
    r"""``F(x) = ||A x - b||² + λ‖x‖₁ + (μ/2)‖x‖²`` (elastic net for μ>0).

    Matches the reference's test formulation ``f = ||Ax-b||²`` (no 1/2),
    so ``∇f = 2 Aᵀ(Ax−b)`` and ``L = 2 λ_max(AᵀA)``.

    ``A`` and ``b`` may be tensors, which keep their device (a CPU tensor
    asks for the CPU), or numpy arrays, which go to ``device`` (default
    ``"cuda"``; a machine with no card raises).  The solve runs on ``A``'s
    device.  ``A`` may be this rank's column block of a feature-sharded
    operator (``distribute_global(A, mesh, P(None, "model"))``), with ``b``
    whole: every solve then runs on the feature blocks, with the
    collectives of the module note, and returns the whole ``x`` on every
    rank.
    """

    def __init__(
        self, A, b, l1_ratio: float, l2_ratio: float = 0.0, device: Any = "cuda"
    ) -> None:
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(np.asarray(A), device=data_device(device))
        A = _operator(A)
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
        r = feature_sum(self.A, _DOT(self.A, x)) - self.b
        val = dot_hp(r, r)
        if self.l2_ratio:
            val = val + 0.5 * self.l2_ratio * feature_sum(self.A, dot_hp(x, x))
        return torch.reshape(val, (1,))

    def jac_f(self, x: Array) -> Array:
        grad = _normal_grad(self.A, self.b, x)
        if self.l2_ratio:
            grad = grad + self.l2_ratio * x
        return torch.reshape(grad, (1, -1))

    def g(self, x: Array) -> Array:
        return torch.reshape(
            self.l1_ratio * feature_sum(self.A, sum_hp(torch.abs(x))), (1,)
        )

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return soft_threshold(x, weight * self.l1_ratio)

    @annotate("zt.lipschitz")
    def lipschitz(
        self, n_iter: int = 50, generator: torch.Generator | None = None
    ) -> float:
        """``L = 2 λ_max(AᵀA) (+ μ)`` — use ``lr = 1/L`` with
        ``decay_rate=1`` for the fixed-step fast path."""
        return float(device_to_host(
            2 * operator_norm_sq(self.A, n_iter, generator=generator) + self.l2_ratio
        ))

    @annotate("zt.solve", call="entry")
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
        return minimize_proximal_gradient(
            _lasso_f_p, _lasso_g_p, _lasso_jac_p, _lasso_prox_p, self._start(x0),
            params=p, **kwargs
        )


class GroupLasso(_OnOperator):
    r"""``F(x) = ||A x - b||² + λ Σ_g ||x_g||₂`` with contiguous equal-size
    feature groups (block soft-threshold prox,
    :func:`~zfista_tpu_torch.ops.prox.prox_group_lasso`).

    ``A`` and ``b`` as in :class:`Lasso` (tensors keep their device, numpy
    goes to ``device``, and ``A`` may be a feature-sharded operator's
    column block); ``n_features`` must divide by ``group_size``, whatever
    the blocks: a group that straddles two ranks' blocks has its norm
    summed over them (:class:`_Groups`).
    """

    def __init__(self, A, b, l1_ratio: float, group_size: int, device: Any = "cuda") -> None:
        A, b = _operands(A, b, device)
        self.A = _operator(A)
        self.b = b.to(self.A.dtype)
        self.l1_ratio = float(l1_ratio)
        self.group_size = int(group_size)
        self._groups = _Groups(self.A, self.group_size)
        super().__init__(n_features=self.A.shape[1], n_objectives=1)

    def f(self, x: Array) -> Array:
        r = feature_sum(self.A, _DOT(self.A, x)) - self.b
        return torch.reshape(dot_hp(r, r), (1,))

    def jac_f(self, x: Array) -> Array:
        return torch.reshape(2 * _DOT(self.A.T, feature_sum(self.A, _DOT(self.A, x)) - self.b), (1, -1))

    def g(self, x: Array) -> Array:
        return torch.reshape(self.l1_ratio * self._groups.norm_sum(x), (1,))

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return self._groups.prox(x, weight * self.l1_ratio)

    @annotate("zt.lipschitz")
    def lipschitz(self, n_iter: int = 50, generator: torch.Generator | None = None) -> float:
        return float(device_to_host(2 * operator_norm_sq(self.A, n_iter, generator=generator)))


class _Groups:
    """The contiguous feature groups of size ``group_size`` as a rank's
    feature block of a feature-sharded ``A`` cuts them (the whole vector
    when ``A`` is whole).

    The block is padded with zeros to whole groups, and the squared sums
    of the groups that straddle a block edge are all-reduced over the
    ``"model"`` ranks: one all-reduce per call, of one entry per
    straddling group of the whole vector (at most one per block edge).
    Where every block starts and ends on group boundaries nothing is
    padded or reduced: a block's prox is bitwise the whole vector's
    :func:`~zfista_tpu_torch.ops.prox.prox_group_lasso` on its features
    (the same operations; group norms sum in an order set by the group
    size alone).  Each group's norm counts in the objective on the rank
    that holds its first feature.
    """

    def __init__(self, A: Array, group_size: int) -> None:
        sh = sharding_of(A)
        k = 1 if sh is None else sh.mesh.size("model")
        r = 0 if sh is None else sh.mesh.index("model")
        n_loc, gs = int(A.shape[1]), int(group_size)
        if (n_loc * k) % gs:
            raise ValueError("n_features must divide by group_size")
        self.size, self.group = gs, None if sh is None else sh.group
        start = r * n_loc
        self.lead = start % gs  # zeros before the block in its first group
        n_groups = -(-(self.lead + n_loc) // gs)
        self.trail = n_groups * gs - self.lead - n_loc
        # The groups that straddle an edge between blocks, in order, and
        # which of them this block holds (first and/or last of its own).
        straddling = sorted({(j * n_loc) // gs for j in range(1, k) if (j * n_loc) % gs})
        first = start // gs
        mine = [j for j in sorted({0, n_groups - 1}) if first + j in straddling]
        self.slots = len(straddling)
        self.at = straddling.index(first + mine[0]) if mine else 0
        self.mine = torch.tensor(mine, dtype=torch.long, device=A.device)
        # Local groups whose norm counts here: all but a first one that
        # began on the previous rank.
        self.counted = slice(1 if self.lead else 0, n_groups)

    def _sq(self, x: Array) -> tuple[Array, Array]:
        """The block as ``(groups, size)`` rows, zero-padded, and each
        group's whole squared sum."""
        v = torch.nn.functional.pad(x, (self.lead, self.trail)).reshape(-1, self.size)
        sq = lane_sum(v * v)
        if self.slots:
            part = sq.index_select(0, self.mine)
            z = lambda n: torch.zeros(n, dtype=sq.dtype, device=sq.device)
            buf = torch.cat([z(self.at), part, z(self.slots - self.at - len(self.mine))])
            total = all_reduce_sum(buf, self.group).narrow(0, self.at, len(self.mine))
            sq = sq.index_copy(0, self.mine, total)
        return v, sq

    def norm_sum(self, x: Array) -> Array:
        """``Σ_g ‖x_g‖₂`` over every group of the whole vector (on every
        rank)."""
        _, sq = self._sq(x)
        local = sum_hp(torch.sqrt(sq[self.counted]))
        return local if self.group is None else all_reduce_sum(local, self.group)

    def prox(self, x: Array, scale) -> Array:
        """:func:`~zfista_tpu_torch.ops.prox.prox_group_lasso` of the whole
        vector, on this block."""
        v, sq = self._sq(x)
        return shrink_groups(v, sq, scale).reshape(-1).narrow(0, self.lead, x.shape[-1])


# Module-level params-style callables for Lasso.solve_fixed_step, with all
# operand data — A, b, lambda (and mu for elastic net) — in the params
# tuple ``p = (A, b, lam[, l2])``.  Pure-LASSO solves omit l2 and pay
# nothing for the elastic-net terms.
# A feature-sharded A (a column block) makes them reduce over its ranks.
def _lasso_f_p(x, p):
    A, b = p[:2]
    r = feature_sum(A, _DOT(A, x)) - b
    val = dot_hp(r, r)
    if len(p) > 3:
        val = val + 0.5 * p[3] * feature_sum(A, dot_hp(x, x))
    return torch.reshape(val, (1,))


def _lasso_jac_p(x, p):
    A, b = p[:2]
    grad = _normal_grad(A, b, x)
    if len(p) > 3:
        grad = grad + p[3] * x
    return torch.reshape(grad, (1, -1))


def _lasso_g_p(x, p):
    lam = p[2]
    return torch.reshape(lam * feature_sum(p[0], sum_hp(torch.abs(x))), (1,))


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
    ``A`` may be a feature-sharded operator's column block: the products
    and the sums over features are then all-reduced over its ``"model"``
    ranks (one all-reduce for every lane), and the batch solver lays the
    lanes out by features on its mesh.  Returns ``(f, g, jac_f, prox)``,
    each taking λ last; pass λ in ``A``'s dtype.
    """
    A, b = _operands(A, b, device)
    A = _operator(A)
    mu = float(l2_ratio)

    def f(x, lam):
        r = feature_sum(A, _DOT(A, x)) - b
        val = dot_hp(r, r)
        if mu:
            val = val + 0.5 * mu * feature_sum(A, dot_hp(x, x))
        return torch.reshape(val, (1,))

    def jac_f(x, lam):
        grad = 2 * _DOT(A.T, feature_sum(A, _DOT(A, x)) - b)
        if mu:
            grad = grad + mu * x
        return torch.reshape(grad, (1, -1))

    def g(x, lam):
        return torch.reshape(lam * feature_sum(A, sum_hp(torch.abs(x))), (1,))

    def prox(weight, x, lam):
        w = weight[0] if getattr(weight, "ndim", 0) else weight
        return soft_threshold(x, w * lam)

    return mark_operator(f, A), g, jac_f, prox


def make_group_lasso_lambda_sweep(A, b, group_size: int, device: Any = "cuda"):
    """Per-lane-λ group-lasso callables for the batch solver (the
    group-lasso half of the sweep config; block soft-threshold prox).
    ``A`` and ``b`` as in :func:`make_lasso_lambda_sweep`, a
    feature-sharded ``A`` with any ``group_size`` that divides ``n``
    (:class:`GroupLasso`).  Returns ``(f, g, jac_f, prox)``, each taking λ
    last.
    """
    A, b = _operands(A, b, device)
    A = _operator(A)
    groups = _Groups(A, group_size)

    def f(x, lam):
        r = feature_sum(A, _DOT(A, x)) - b
        return torch.reshape(dot_hp(r, r), (1,))

    def jac_f(x, lam):
        return torch.reshape(2 * _DOT(A.T, feature_sum(A, _DOT(A, x)) - b), (1, -1))

    def g(x, lam):
        return torch.reshape(lam * groups.norm_sum(x), (1,))

    def prox(weight, x, lam):
        w = weight[0] if getattr(weight, "ndim", 0) else weight
        return groups.prox(x, w * lam)

    return mark_operator(f, A), g, jac_f, prox


def fista_step_dense(A: Array, b: Array, lam: Array, lr: Array, carry):
    """One fixed-step FISTA iteration on dense LASSO, written as a plain
    function ``carry=(x, y, t) -> carry`` — the unfused step that
    :func:`zfista_tpu_torch.ops.fused.fista_step_dense_fused` replaces.
    ``t`` is a 0-d tensor.  A feature-sharded ``A`` (a column block, with
    ``x, y`` the feature blocks) all-reduces ``A @ y`` between the two
    matvecs; the rest is local, ``t`` replicated.
    """
    x, y, t = carry
    grad = 2 * _DOT(A.T, feature_sum(A, _DOT(A, y)) - b)
    x_new = soft_threshold(y - lr * grad, lr * lam)
    t_new = torch.sqrt(t * t + 0.25) + 0.5
    y_new = x_new + ((t - 1) / t_new) * (x_new - x)
    return x_new, y_new, t_new
