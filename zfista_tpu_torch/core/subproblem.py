r"""Solvers for the proximal subproblem of one outer iteration.

PyTorch-port counterpart of :mod:`zfista_tpu.core.subproblem`.  At each
outer iteration the method solves

.. math::

    \min_x \; \max_i \big[ \nabla f_i(y)^\top (x - y) + g_i(x)
        + f_i(y) - F_i(x_{old}) \big] + \tfrac{1}{2\,lr}\|x - y\|^2

through its Fenchel dual over the probability simplex: minimize

.. math::

    \varphi(w) = -\langle w, g(x_w)\rangle - \tfrac{1}{2\,lr}\|x_w - u_w\|^2
        + \tfrac{lr}{2}\|J^\top w\|^2 + \langle w, F_{old} - f(y)\rangle,

with :math:`u_w = y - lr\,J^\top w` and
:math:`x_w = \mathrm{prox}_{lr\,w^\top g}(u_w)`, whose gradient is
:math:`-(g_i(x_w) + \nabla f_i(y)^\top (x_w - y)) + (F_{old,i} - f_i(y))`.

* ``m == 1`` — one closed-form prox step.
* ``m == 2`` — bisection on :math:`\psi(t) = \partial_t\varphi([t,1-t])`.
  The JAX package bounds its ``while_loop`` by a static count and a width
  floor; both are static here too (the interval after ``k`` halvings of
  ``[0, 1]`` is exactly ``2**-k`` wide), so the port runs exactly that
  many steps on the device with no host read.  The vertex exits are
  computed beside the bisection and selected.
* ``m >= 3`` — semismooth projected Newton on the simplex, with the
  generalized Hessian from autodiff through the prox, a two-metric active
  set, an arc search and a projected-gradient safeguard.  The JAX package
  takes the Hessian with ``jax.jacfwd``; the port takes it with
  ``torch.func.jacrev``.  Both chain the same local derivatives (torch's
  ``maximum``/``minimum`` split 1/2-1/2 at a tie in either mode, as
  ``jnp.maximum`` does), so they give the same Clarke-Jacobian element.
  Eager forward mode is the slow one here: an op with a constant operand
  (a zero tangent) costs ~0.3-0.5 ms under ``torch.func.jvp``, and one
  ``jacfwd`` Hessian of the FDS dual ~8 ms on a CPU core against ~1.7 ms
  for ``jacrev``.
  One Newton iteration reads nothing on the host (:func:`make_newton`):
  each Armijo arc search evaluates its 40 trials at once on a trial axis
  and takes the first accepted one, as the JAX inner ``while_loop``
  would.  The eager solver loops over iterations with one host read each;
  the solver's carried search (:mod:`zfista_tpu_torch.core.solver`) takes
  one iteration a step, with no read.

``SubproblemResult.nit`` adds up exactly as the JAX package's does.

On a feature-sharded solve each rank holds a block of ``y`` and of the
Jacobian's columns, and the weight ``w`` is the same on every rank.  The
dual's sums over features are all-reduced (``feature_sum``, one
all-reduce for every lane and trial under ``vmap``); ``g`` reduces its
own.  The Hessian takes the first of two exact routes: the all-reduce's
derivative is the identity on this rank's operand (the other ranks'
operands held fixed; :mod:`zfista_tpu_torch.parallel.sharding`), so
``jacrev`` gives each rank its blocks' share of ``d grad / dw``, and one
more all-reduce sums the shares (:func:`dual_hessian`).  That sum is the
whole Hessian because every path from ``w`` to the gradient crosses one
all-reduce, ``g``'s or the product ``J (x_w - y)``'s: the prox is
elementwise and the shift does not depend on ``w``.  The other route, a
forward-mode rule that all-reduces each tangent, would need eager
forward mode, the slow one here.  Every rank gets the same bits, so every
rank takes the same host decisions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.ops.precision import dot_hp, lane_sum, matmul_hp, sum_hp
from zfista_tpu_torch.ops.prox import DeviceConstants, project_simplex
from zfista_tpu_torch.utils.profiling import annotate, device_to_host, read_flag

_DOT = matmul_hp
_VDOT = dot_hp


class SubproblemResult(NamedTuple):
    x: Array  # (n,) primal solution
    fun: Array | None  # scalar primal subproblem value (None: not asked for)
    weight: Array  # (m,) dual solution
    nit: int | Array  # inner iterations used (0-d int32 tensor for m == 2)


def _eps(dtype: torch.dtype) -> float:
    """The JAX package's two-way machine-epsilon rule."""
    return 2.2e-16 if dtype == torch.float64 else 1.2e-7


class _Dual(NamedTuple):
    grad: Callable[[Array], Array]
    value: Callable[[Array], Array]
    value_and_grad: Callable[[Array], tuple[Array, Array]]
    value_and_primal: Callable[[Array], tuple[Array, Array]]


def _make_dual(
    f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated: bool, feature_sum=None
) -> _Dual:
    """Closures for the dual objective and gradient at a weight ``w``.

    The JAX version returns ``value_and_grad`` and lets XLA drop whichever
    half a caller ignores; eager PyTorch has no dead-code elimination, so
    the gradient-only and value-only halves are closures of their own.

    ``feature_sum`` (``y`` and ``jac_f_y`` are a rank's feature blocks,
    and ``g`` reduces over the ranks itself) all-reduces the sums over
    features: the gradient's product ``J (x_w - y)`` is one all-reduce, the
    value's two squared norms another, and ``value_and_grad`` takes all
    three in one.  The prox is elementwise and stays local.
    """
    shift = torch.zeros_like(f_y) if deprecated else F_old - f_y
    fsum = feature_sum if feature_sum is not None else (lambda v: v)

    def _eval(w: Array):
        wsum_jac = _DOT(w, jac_f_y)
        u = y - lr * wsum_jac
        x_w = prox_wsum_g(lr * w, u)
        return wsum_jac, u, x_w

    def _sums(wsum_jac, u, x_w, product: bool):
        """``(||x_w - u||^2, ||J^T w||^2, J (x_w - y) or None)``."""
        diff = x_w - u
        dd, jj = _VDOT(diff, diff), _VDOT(wsum_jac, wsum_jac)
        prod = _DOT(jac_f_y, x_w - y) if product else None
        if feature_sum is None:
            return dd, jj, prod
        s = feature_sum(torch.cat([dd[None], jj[None]] + ([prod] if product else [])))
        return s[0], s[1], s[2:] if product else None

    def _fun(w, g_xw, dd, jj):
        return -_VDOT(w, g_xw) - dd / (2 * lr) + (lr / 2) * jj + _VDOT(w, shift)

    def grad(w: Array) -> Array:
        _, _, x_w = _eval(w)
        return -g(x_w) - fsum(_DOT(jac_f_y, x_w - y)) + shift

    def value(w: Array) -> Array:
        wsum_jac, u, x_w = _eval(w)
        dd, jj, _ = _sums(wsum_jac, u, x_w, False)
        return _fun(w, g(x_w), dd, jj)

    def value_and_grad(w: Array):
        wsum_jac, u, x_w = _eval(w)
        g_xw = g(x_w)
        dd, jj, prod = _sums(wsum_jac, u, x_w, True)
        return _fun(w, g_xw, dd, jj), -g_xw - prod + shift

    def value_and_primal(w: Array):
        wsum_jac, u, x_w = _eval(w)
        dd, jj, _ = _sums(wsum_jac, u, x_w, False)
        return _fun(w, g(x_w), dd, jj), x_w

    return _Dual(grad, value, value_and_grad, value_and_primal)


def dual_hessian(grad: Callable[[Array], Array], w: Array, feature_sum=None) -> Array:
    """The Jacobian of the dual gradient ``grad`` at ``w``, the Newton
    step's generalized Hessian, by ``torch.func.jacrev``.

    On feature blocks (``feature_sum``) the weight ``w`` is the same on
    every rank, and ``grad`` reaches it through all-reduces whose
    derivative is taken with respect to this rank's own operand
    (:mod:`zfista_tpu_torch.parallel.sharding`): the cotangent passes
    through each unchanged, so ``jacrev`` gives this rank's blocks' share
    ``sum over its features of d(terms)/dw``.  The whole Hessian is the sum
    of the shares over the ranks, one all-reduce, and the same bits on
    every rank.  It is exact because every path from ``w`` to ``grad``
    crosses one all-reduce: ``g``'s own sum over features or that of the
    product ``J (x_w - y)``; ``x_w`` is elementwise in ``u = y - lr J^T w``
    and ``shift`` does not depend on ``w``.  The JAX package gets the same
    sum from XLA (``jax.jacfwd`` over a sharded program).
    """
    H = torch.func.jacrev(grad)(w)
    return H if feature_sum is None else feature_sum(H)


def solve_small_linear(K: Array, b: Array) -> Array:
    """Solve ``K x = b`` for a SMALL square system by unrolled Gauss-Jordan
    elimination with partial pivoting, as the JAX package does.

    ``torch.linalg.solve`` is not used: it raises on a singular system,
    where this returns inf/NaN (a zero pivot divides through, IEEE
    semantics) — which the Newton solver's fallback to the projected
    gradient relies on.  No host read: the pivot row is swapped in by an
    index permutation on the device.
    """
    n = K.shape[-1]
    A = torch.cat([K, b[:, None]], dim=-1)
    idx = torch.arange(n, device=K.device)
    for k in range(n):
        mag = torch.where(idx < k, -math.inf, torch.abs(A[:, k]))
        p = torch.argmax(mag)
        perm = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        A = torch.index_select(A, 0, perm)
        row_scaled = A[k] / A[k, k]
        factors = torch.where(idx == k, 0.0, A[:, k])
        A = A - factors[:, None] * row_scaled[None, :]
        A = torch.where((idx == k)[:, None], row_scaled[None, :], A)
    return A[:, n]


def _bisection_steps(n_bisect: int, floor: float, dtype: torch.dtype) -> int:
    """The halvings the JAX loop takes: while ``hi - lo > floor`` and
    fewer than ``n_bisect``.  ``hi - lo`` is exactly ``2**-k`` after ``k``
    halvings of ``[0, 1]`` (dyadic endpoints, exact in the dtype), so the
    count is static; it is computed in the dtype's own arithmetic."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    width, floor_d, k = np_dtype(1.0), np_dtype(floor), 0
    while width > floor_d and k < n_bisect:
        width = np_dtype(width / 2)
        k += 1
    return k


def make_subproblem_solver(
    g: Callable[[Array], Array],
    prox_wsum_g: Callable[[Array, Array], Array],
    n_objectives: int,
    *,
    tol: float,
    max_iter: int,
    deprecated: bool = False,
    feature_sum: Callable[[Array], Array] | None = None,
) -> Callable[..., SubproblemResult]:
    """Build ``solve(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult``.

    ``feature_sum`` (a feature-sharded solve: ``y`` and ``jac_f_y`` are a
    rank's feature blocks, ``g`` reduces over the ranks itself) all-reduces
    the sums over features across the ranks: the m = 1 model value's, and
    the dual's (:func:`_make_dual`) at m >= 2.  One m = 2 ``psi`` then
    costs two all-reduces (``g``'s and the product's) and the bisection
    reads nothing; one m >= 3 Newton iteration costs eight (see
    :func:`make_newton`).  Every quantity a host decision reads (the
    Newton loop's exit test, ``nit``) is computed from all-reduced values,
    so every rank takes it alike."""
    m = n_objectives
    fsum = feature_sum if feature_sum is not None else (lambda v: v)

    if m == 1:

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
                fun = fsum(_VDOT(grad, d)) + g(x)[0] + fsum(_VDOT(d, d)) / (2 * lr)
                if not deprecated:
                    fun = fun + (f_y[0] - F_old[0])
            return SubproblemResult(x=x, fun=fun, weight=ones, nit=1)

        return solve_scalar

    if m == 2:
        n_bisect = min(
            max(int(math.ceil(math.log2(1.0 / max(tol, 1e-15)))), 1), max_iter
        )

        def solve_m2(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult:
            dual = _make_dual(
                f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated, feature_sum
            )

            def psi(t):
                # Directional derivative of phi along w = [t, 1-t].
                grad = dual.grad(torch.stack([t, 1 - t]))
                return grad[0] - grad[1]

            dtype, dev = y.dtype, y.device
            zero = torch.zeros((), dtype=dtype, device=dev)
            one = torch.ones((), dtype=dtype, device=dev)
            psi0 = psi(zero)
            psi1 = psi(one)
            steps = _bisection_steps(n_bisect, max(tol, 2.3e-16 if dtype == torch.float64 else 1.2e-7), dtype)

            # The bisection runs whether or not the optimum is a vertex (no
            # host read to decide); the vertex exits select past it.
            lo, hi = zero, one
            for _ in range(steps):
                mid = (lo + hi) / 2
                neg = psi(mid) < 0
                lo = torch.where(neg, mid, lo)
                hi = torch.where(neg, hi, mid)
            # phi convex => psi nondecreasing: interior iff psi(0) < 0 < psi(1)
            # (NaN falls through to the bisection, as in the JAX lax.cond).
            at0, at1 = psi0 >= 0, psi1 <= 0
            t_star = torch.where(at0, zero, torch.where(at1, one, (lo + hi) / 2))
            interior = ~at0 & ~at1
            w = torch.stack([t_star, 1 - t_star])
            phi_star, x = dual.value_and_primal(w)
            # nit: 2 endpoint psi's + the bisection steps an interior solve
            # takes.
            return SubproblemResult(
                x=x, fun=-phi_star, weight=w, nit=interior.to(torch.int32) * steps + 2
            )

        return solve_m2

    # m >= 3: semismooth projected Newton on the simplex (see the JAX
    # module for the design and make_newton here for the parts).
    parts = make_newton(
        g, prox_wsum_g, m, tol=tol, max_iter=max_iter, deprecated=deprecated,
        feature_sum=feature_sum,
    )

    def solve_mk(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult:
        """The JAX ``lax.while_loop`` as a host loop over
        :func:`make_newton`'s ``iterate``: one host read per Newton
        iteration (the loop's test, with the count riding on it), none
        inside one.  ``nit`` is a host int."""
        args = (lr, F_old, y, f_y, jac_f_y)
        c = parts.start(*args, w0)
        while True:
            with annotate("zt.host_read"):
                flags = torch.stack([c.nit, parts.ended(c).to(torch.int32)])
                nit, ended = device_to_host(flags).tolist()
            if ended:
                break
            c = parts.iterate(c, *args)
        return parts.finish(c, *args)._replace(nit=nit)

    solve_mk.newton = parts
    return solve_mk


class Newton(NamedTuple):
    """The m >= 3 solver's loop state, the JAX ``solve_mk`` carry: one
    lane's 0-d fields and ``(m,)`` weight, or every lane's with a leading
    lane axis."""

    w: Array  # (m,) the dual iterate
    phi: Array  # its dual value (0 before the first iteration)
    k: Array  # Newton iterations taken (int32)
    done: Array  # bool
    nit: Array  # inner count so far (int32)
    stall: Array  # iterations in a row without real progress (int32)


class NewtonParts(NamedTuple):
    """The m >= 3 solver in parts that read nothing on the host, each
    taking the subproblem's data ``(lr, F_old, y, f_y, jac_f_y)``:
    ``start(*data, w0)`` makes the carry, ``iterate(carry, *data)`` takes
    one Newton iteration (a carry that has ``ended`` passes through
    unchanged), ``ended(carry)`` is the loop's exit test, and
    ``finish(carry, *data)`` is the :class:`SubproblemResult`."""

    start: Callable[..., Newton]
    iterate: Callable[..., Newton]
    ended: Callable[[Newton], Array]
    finish: Callable[..., SubproblemResult]


#: Trials of one Armijo arc search, as in the JAX ``ls_cond``.
ARC_TRIALS = 40
#: The arc's steps ``a_j = 2**-(j-1)``: repeated halving from 1 is exact in
#: binary, so these are the sequential loop's steps, bit for bit.
_HALVINGS = DeviceConstants(a=0.5 ** np.arange(ARC_TRIALS))


def arc_searches(w, d_first, d_pg, bad, phi, grad, slack, values):
    """The JAX ``body``'s two Armijo arc searches along ``w(a) =
    P_simplex(w + a d)``, ``a = 1, 1/2, ..., 2**-39``, with every trial of
    both arcs evaluated at once: ``values(W)`` is the dual's value at each
    row of ``W (2 * ARC_TRIALS, m)``.  Each arc stops at its first
    accepted trial or at trial 40, as the sequential search does; the
    projected-gradient arc ``d_pg`` counts only where the JAX ``lax.cond``
    runs it: the Newton arc ``d_first`` failed and was not already the
    projected gradient (``bad``).  A trial that does not move is never
    accepted: it falls through to the PG arc, whose failure is the
    stationarity certificate.  Returns ``(ok, trials, w_new, phi_new)``,
    with ``w`` and ``phi`` kept where no arc was accepted (the numerical
    floor)."""
    m = w.shape[-1]
    a = _HALVINGS.on(w)["a"]
    W = project_simplex(w + a[None, :, None] * torch.stack([d_first, d_pg])[:, None, :])
    phi_t = values(W.reshape(2 * ARC_TRIALS, m)).reshape(2, ARC_TRIALS)
    moved = torch.any(W != w, dim=-1)
    ok_t = moved & (phi_t <= phi + 1e-4 * lane_sum(grad * (W - w)) + slack)
    # Each arc's count, point and value where the sequential search stops.
    number = torch.arange(1, ARC_TRIALS + 1, dtype=torch.int32, device=w.device)
    first = torch.amin(torch.where(ok_t, number, ARC_TRIALS + 1), dim=-1)
    n_arc = torch.clamp_max(first, ARC_TRIALS)
    at = (n_arc - 1).to(torch.int64)
    w_arc = torch.gather(W, 1, at[:, None, None].expand(2, 1, m))[:, 0]
    phi_arc = torch.gather(phi_t, 1, at[:, None])[:, 0]
    ok1 = first[0] <= ARC_TRIALS
    retry = ~(ok1 | bad)
    ok = ok1 | (retry & (first[1] <= ARC_TRIALS))
    n_ls = n_arc[0] + torch.where(retry, n_arc[1], 0)
    w_new = torch.where(ok, torch.where(retry, w_arc[1], w_arc[0]), w)
    phi_new = torch.where(ok, torch.where(retry, phi_arc[1], phi_arc[0]), phi)
    return ok, n_ls, w_new, phi_new


def make_newton(
    g: Callable[[Array], Array],
    prox_wsum_g: Callable[[Array, Array], Array],
    n_objectives: int,
    *,
    tol: float,
    max_iter: int,
    deprecated: bool = False,
    feature_sum: Callable[[Array], Array] | None = None,
) -> NewtonParts:
    """The m >= 3 semismooth projected Newton solver of one lane as
    :class:`NewtonParts`: the JAX ``init``, ``body`` and ``cond`` of
    ``solve_mk`` and its final ``vap``.

    ``iterate`` is the JAX ``body``: the ``jacrev`` Hessian, the
    two-metric KKT step, and both Armijo arc searches with their 40
    trials evaluated at once on a trial axis (the projected-gradient arc
    always computed, used and counted only where the JAX ``lax.cond``
    runs it).  The trial count is the first accepted trial's number, or
    40, as the sequential search counts it.  The trials' sums are
    :func:`~zfista_tpu_torch.ops.precision.lane_sum` trees (the dual under
    ``vmap`` over the trials, its Jacobian expanded so that no product is
    one GEMM over them), so a trial's value does not depend on the trials
    or lanes beside it.  Every part runs under ``torch.func.vmap`` over
    lanes (:func:`make_batch_newton`).

    ``feature_sum`` (feature blocks, as :func:`make_subproblem_solver`
    takes it) reduces the dual's sums, the scale's ``trace(J J^T)`` and
    the Hessian (:func:`dual_hessian`) over the ranks.  One iteration then
    costs eight all-reduces, each one for every lane and trial under
    ``vmap``: the scale, ``g``'s and the dual's in ``value_and_grad``, the
    two that ``jacrev`` runs forward and the Hessian's, ``g``'s and the
    value's over the 80 arc trials at once (``g`` adds a max for a box)."""
    m = n_objectives
    newton_cap = min(max_iter, 30)
    fsum = feature_sum if feature_sum is not None else (lambda v: v)

    def dual_at(lr, F_old, y, f_y, jac_f_y) -> _Dual:
        return _make_dual(f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated, feature_sum)

    def trial_values(W, lr, F_old, y, f_y, jac_f_y):
        """The dual's value at each row of ``W (T, m)``."""
        J = jac_f_y.expand(W.shape[0], *jac_f_y.shape)
        value = lambda w, Jt: dual_at(lr, F_old, y, f_y, Jt).value(w)  # noqa: E731
        return torch.func.vmap(value)(W, J)

    def start(lr, F_old, y, f_y, jac_f_y, w0) -> Newton:
        like = F_old[0]
        return Newton(
            w=project_simplex(w0.to(y.dtype)),
            phi=torch.zeros_like(like),
            k=torch.zeros_like(like, dtype=torch.int32),
            done=torch.zeros_like(like, dtype=torch.bool),
            nit=torch.ones_like(like, dtype=torch.int32),
            stall=torch.zeros_like(like, dtype=torch.int32),
        )

    def ended(c: Newton) -> Array:
        return c.done | (c.k >= newton_cap)

    def iterate(c: Newton, lr, F_old, y, f_y, jac_f_y) -> Newton:
        dual = dual_at(lr, F_old, y, f_y, jac_f_y)
        # Gradient-mapping scale: trace(J Jᵀ) >= lambda_max, no eigensolver.
        Ls = torch.clamp_min(lr * fsum(sum_hp(jac_f_y * jac_f_y)), 1.0)
        dtype, dev = y.dtype, y.device
        eps = _eps(dtype)
        delta = 1e-12 if dtype == torch.float64 else 1e-6
        stat_tol = max(tol, 100 * eps)
        w = c.w
        phi, grad = dual.value_and_grad(w)
        H = dual_hessian(dual.grad, w, feature_sum) + delta * torch.eye(m, dtype=dtype, device=dev)

        # Active set from the projected-gradient point (multiplier-correct
        # on the simplex): free iff w_pg > 0.
        w_pg = project_simplex(w - grad / Ls)
        fm = (w_pg > 0).to(dtype)
        d_active = (1.0 - fm) * (w_pg - w)
        K = torch.cat(
            [
                torch.cat([H * torch.outer(fm, fm) + torch.diag(1.0 - fm), fm[:, None]], dim=1),
                torch.cat([fm, torch.zeros_like(fm[:1])])[None, :],
            ],
            dim=0,
        )
        rhs = torch.cat([-(grad + _DOT(H, d_active)) * fm, -sum_hp(d_active)[None]])
        d_newton = solve_small_linear(K, rhs)[:m] + d_active

        d_pg = w_pg - w
        bad = (~torch.all(torch.isfinite(d_newton))) | (_VDOT(grad, d_newton) >= 0)
        d_first = torch.where(bad, d_pg, d_newton)
        slack = 4 * eps * (1 + torch.abs(phi))

        values = lambda W: trial_values(W, lr, F_old, y, f_y, jac_f_y)  # noqa: E731
        ok, n_ls, w_new, phi_new = arc_searches(w, d_first, d_pg, bad, phi, grad, slack, values)

        # Scaled gradient mapping, and the progress-based floor.
        gm = torch.sqrt(sum_hp((w - w_pg) * (w - w_pg)))
        stationary = gm <= stat_tol * (1 + torch.sqrt(sum_hp(grad * grad)) / Ls)
        progressed = (phi - phi_new) > eps * (1 + torch.abs(phi))
        stall = torch.where(progressed, 0, c.stall + 1)
        new = Newton(
            w=w_new,
            phi=phi_new,
            k=c.k + 1,
            done=stationary | ~ok | (stall >= 2),
            nit=c.nit + n_ls + (m + 1),  # m tangents for H + phi evals
            stall=stall,
        )
        going = ~ended(c)
        return Newton(*(torch.where(going, u, v) for u, v in zip(new, c)))

    def finish(c: Newton, lr, F_old, y, f_y, jac_f_y) -> SubproblemResult:
        phi_star, x = dual_at(lr, F_old, y, f_y, jac_f_y).value_and_primal(c.w)
        return SubproblemResult(x=x, fun=-phi_star, weight=c.w, nit=c.nit)

    return NewtonParts(start, iterate, ended, finish)


# -- lane-batched solvers ------------------------------------------------------
#
# The batch solver (zfista_tpu_torch.parallel.batch) advances B independent
# solves together: every tensor below carries a leading lane axis.  The JAX
# package gets the same by jax.vmap over the single solvers, where XLA turns
# each lane's while_loop into one masked loop.  Here every solver is the
# single one under torch.func.vmap: m=1 and m=2 whole, m>=3 as its parts
# (make_newton), which read nothing, so a lane's Newton iterations are its
# single solver's, and a host loop over them reads once per round.


def _over_lanes(fn: Callable, n_args: int, params) -> Callable:
    """``fn(*args, *p)`` of one lane, applied to every lane: vmapped over the
    leading axis of its ``n_args`` tensors and of ``params``, passed as the
    last argument (none when ``params`` is ``None``)."""
    if params is None:
        return torch.func.vmap(fn, in_dims=(0,) * n_args)
    v = torch.func.vmap(fn, in_dims=(0,) * (n_args + 1))
    return lambda *args: v(*args, params)


def make_batch_subproblem_solver(
    g: Callable,
    prox_wsum_g: Callable,
    n_objectives: int,
    params,
    *,
    tol: float,
    max_iter: int,
    deprecated: bool = False,
    feature_sum: Callable[[Array], Array] | None = None,
) -> Callable[..., SubproblemResult]:
    """Build ``solve(lr, F_old, y, f_y, jac_f_y, w0, live) ->
    SubproblemResult`` over a leading lane axis.

    ``g(x, *p)`` and ``prox_wsum_g(w, x, *p)`` are one lane's vector-form
    callables with the lane's params last (none when ``params``, every
    lane's with a leading axis, is ``None``).  ``live (B,)`` marks the lanes whose result
    is used: the m>=3 loops start with the others done, so they never run
    longer for them.  ``nit (B,)`` is each lane's own count, as the single
    solver counts it; ``fun`` is ``None`` when ``f_y`` is (m=1).
    ``feature_sum`` (lanes that are feature blocks, any m) reduces the sums
    over features over the ranks inside ``vmap``, as the single solver
    does: one all-reduce for every lane
    (:func:`zfista_tpu_torch.parallel.sharding.all_reduce_sum`).
    """
    m = n_objectives

    def single(*p):
        return make_subproblem_solver(
            lambda x: g(x, *p),
            lambda w, x: prox_wsum_g(w, x, *p),
            m,
            tol=tol,
            max_iter=max_iter,
            deprecated=deprecated,
            feature_sum=feature_sum,
        )

    if m <= 2:

        def lane(lr, F_old, y, f_y, jac_f_y, w0, *p):
            sub = single(*p)(lr, F_old, y, f_y, jac_f_y, w0)
            if m == 1:
                return (sub.x, sub.weight) + (() if f_y is None else (sub.fun,))
            return sub.x, sub.weight, sub.fun, sub.nit

        v_with_fy = _over_lanes(lane, 6, params)
        v_without_fy = _over_lanes(
            lambda lr, F_old, y, jac, w0, *p: lane(lr, F_old, y, None, jac, w0, *p), 5, params
        )

        def solve_low(lr, F_old, y, f_y, jac_f_y, w0, live) -> SubproblemResult:
            if f_y is None:
                out = v_without_fy(lr, F_old, y, jac_f_y, w0)
            else:
                out = v_with_fy(lr, F_old, y, f_y, jac_f_y, w0)
            x, w = out[:2]
            fun = out[2] if len(out) > 2 else None
            if m == 1:
                nit = torch.ones(y.shape[0], dtype=torch.int32, device=y.device)
            else:
                nit = out[3]
            return SubproblemResult(x=x, fun=fun, weight=w, nit=nit)

        return solve_low

    # m >= 3: the single solver's parts over lanes.  A lane that is done (or
    # not live) passes through each iteration; a host loop runs them while
    # any lane iterates: one read per Newton round, whatever the lanes.
    newton = make_batch_newton(
        g, prox_wsum_g, m, params, tol=tol, max_iter=max_iter, deprecated=deprecated,
        feature_sum=feature_sum,
    )

    def solve_mk_batched(lr, F_old, y, f_y, jac_f_y, w0, live) -> SubproblemResult:
        args = (lr, F_old, y, f_y, jac_f_y)
        c = newton.start(*args, w0)
        c = c._replace(done=c.done | ~live)
        while read_flag(torch.any(~newton.ended(c))):  # the one read per Newton round
            c = newton.iterate(c, *args)
        return newton.finish(c, *args)

    solve_mk_batched.newton = newton
    return solve_mk_batched


def make_batch_newton(
    g: Callable,
    prox_wsum_g: Callable,
    n_objectives: int,
    params,
    *,
    tol: float,
    max_iter: int,
    deprecated: bool = False,
    feature_sum: Callable[[Array], Array] | None = None,
) -> NewtonParts:
    """:func:`make_newton`'s parts over a leading lane axis, with one
    lane's callables ``g(x, *p)`` and ``prox_wsum_g(w, x, *p)`` (params
    last, as :func:`make_batch_subproblem_solver` takes them): each part
    is the single lane's under ``torch.func.vmap``, so a lane's carry
    moves as its single solver's would, whatever the lanes beside it."""

    def lane(*p) -> NewtonParts:
        return make_newton(
            lambda x: g(x, *p), lambda w, x: prox_wsum_g(w, x, *p), n_objectives,
            tol=tol, max_iter=max_iter, deprecated=deprecated, feature_sum=feature_sum,
        )

    def start(lr, F_old, y, f_y, J, w0, *p):
        return lane(*p).start(lr, F_old, y, f_y, J, w0)

    def iterate(c, lr, F_old, y, f_y, J, *p):
        return lane(*p).iterate(c, lr, F_old, y, f_y, J)

    def finish(c, lr, F_old, y, f_y, J, *p):
        return lane(*p).finish(c, lr, F_old, y, f_y, J)

    return NewtonParts(
        _over_lanes(start, 6, params),
        _over_lanes(iterate, 6, params),
        lane().ended,  # reads the carry alone
        _over_lanes(finish, 6, params),
    )
