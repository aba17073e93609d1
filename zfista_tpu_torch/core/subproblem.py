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
  The Newton loop and the arc search are host loops: one host read per
  arc-search trial and one per Newton iteration.

``SubproblemResult.nit`` adds up exactly as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.ops.precision import dot_hp, lane_sum, matmul_hp, sum_hp
from zfista_tpu_torch.ops.prox import project_simplex

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


def _make_dual(f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated: bool) -> _Dual:
    """Closures for the dual objective and gradient at a weight ``w``.

    The JAX version returns ``value_and_grad`` and lets XLA drop whichever
    half a caller ignores; eager PyTorch has no dead-code elimination, so
    the gradient-only and value-only halves are closures of their own.
    """
    shift = torch.zeros_like(f_y) if deprecated else F_old - f_y

    def _eval(w: Array):
        wsum_jac = _DOT(w, jac_f_y)
        u = y - lr * wsum_jac
        x_w = prox_wsum_g(lr * w, u)
        return wsum_jac, u, x_w

    def _fun(w, wsum_jac, u, x_w, g_xw):
        diff = x_w - u
        return (
            -_VDOT(w, g_xw)
            - _VDOT(diff, diff) / (2 * lr)
            + (lr / 2) * _VDOT(wsum_jac, wsum_jac)
            + _VDOT(w, shift)
        )

    def grad(w: Array) -> Array:
        _, _, x_w = _eval(w)
        return -g(x_w) - _DOT(jac_f_y, x_w - y) + shift

    def value(w: Array) -> Array:
        wsum_jac, u, x_w = _eval(w)
        return _fun(w, wsum_jac, u, x_w, g(x_w))

    def value_and_grad(w: Array):
        wsum_jac, u, x_w = _eval(w)
        g_xw = g(x_w)
        fun = _fun(w, wsum_jac, u, x_w, g_xw)
        return fun, -g_xw - _DOT(jac_f_y, x_w - y) + shift

    def value_and_primal(w: Array):
        wsum_jac, u, x_w = _eval(w)
        return _fun(w, wsum_jac, u, x_w, g(x_w)), x_w

    return _Dual(grad, value, value_and_grad, value_and_primal)


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

    ``feature_sum`` (m == 1 only) all-reduces the model value's sums over
    features across the ranks of a feature-sharded solve."""
    m = n_objectives
    if feature_sum is not None and m != 1:
        raise NotImplementedError("a feature-sharded subproblem takes one objective")
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
            dual = _make_dual(f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated)

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
    # module for the design: two-metric projection, multiplier-correct
    # active set, arc search, projected-gradient safeguard, stall floor).
    newton_cap = min(max_iter, 30)

    def solve_mk(lr, F_old, y, f_y, jac_f_y, w0) -> SubproblemResult:
        dual = _make_dual(f_y, jac_f_y, F_old, g, prox_wsum_g, lr, y, deprecated)
        dtype, dev = y.dtype, y.device
        eps = _eps(dtype)
        delta = 1e-12 if dtype == torch.float64 else 1e-6
        stat_tol = max(tol, 100 * eps)
        hess_fn = torch.func.jacrev(dual.grad)
        eye = torch.eye(m, dtype=dtype, device=dev)
        zero1 = torch.zeros((1,), dtype=dtype, device=dev)

        # Gradient-mapping scale: trace(J Jᵀ) >= lambda_max, no eigensolver.
        lam_bound = sum_hp(jac_f_y * jac_f_y)
        Ls = torch.clamp_min(lr * lam_bound, 1.0)

        w = project_simplex(w0.to(dtype))
        nit = 1
        stall = 0
        for _ in range(newton_cap):
            phi_k, grad = dual.value_and_grad(w)
            H = hess_fn(w) + delta * eye

            # Active set from the projected-gradient point (multiplier-
            # correct on the simplex): free iff w_pg > 0.
            w_pg = project_simplex(w - grad / Ls)
            fm = (w_pg > 0).to(dtype)
            d_active = (1.0 - fm) * (w_pg - w)
            K = torch.cat(
                [
                    torch.cat(
                        [H * torch.outer(fm, fm) + torch.diag(1.0 - fm), fm[:, None]],
                        dim=1,
                    ),
                    torch.cat([fm, zero1])[None, :],
                ],
                dim=0,
            )
            rhs = torch.cat(
                [-(grad + _DOT(H, d_active)) * fm, -torch.sum(d_active)[None]]
            )
            d_newton = solve_small_linear(K, rhs)[:m] + d_active

            d_pg = w_pg - w
            bad = (~torch.all(torch.isfinite(d_newton))) | (_VDOT(grad, d_newton) >= 0)
            d_first = torch.where(bad, d_pg, d_newton)

            slack = 4 * eps * (1 + torch.abs(phi_k))

            def accept(w_t, phi_t):
                # A trial that does not move is never accepted: it falls
                # through to the PG arc, whose failure is the stationarity
                # certificate.
                moved = torch.any(w_t != w)
                return moved & (phi_t <= phi_k + 1e-4 * _VDOT(grad, w_t - w) + slack)

            def arc_search(d, also=None):
                """Armijo along w(a) = P_simplex(w + a d), a = 1, 1/2, ...;
                at most 40 trials, one host read each.  ``also`` rides on
                the first read.  Returns (ok, trials, w_t, phi_t, also)."""
                a = 1.0
                w_t = project_simplex(w + d)
                phi_t = dual.value(w_t)
                ok = accept(w_t, phi_t)
                if also is None:
                    ok_b, also_b = bool(ok), None
                else:
                    ok_b, also_b = torch.stack([ok, also]).tolist()
                j = 1
                while not ok_b and j < 40:
                    a *= 0.5
                    w_t = project_simplex(w + a * d)
                    phi_t = dual.value(w_t)
                    ok_b = bool(accept(w_t, phi_t))
                    j += 1
                return ok_b, j, w_t, phi_t, also_b

            ok, n_ls, w_new, phi_new, bad_b = arc_search(d_first, bad)
            # Retry along the projected gradient unless the first arc
            # succeeded or already was the projected gradient (``bad``);
            # both are on the host from the first arc's reads.
            if not ok and not bad_b:
                ok, n2, w_new, phi_new, _ = arc_search(d_pg)
                n_ls += n2
            nit += n_ls + m + 1  # m tangents for H + phi evals
            if not ok:  # the numerical floor: w stays
                break

            # Scaled gradient mapping, and the progress-based floor.
            gm = torch.linalg.vector_norm(w - w_pg)
            stationary = gm <= stat_tol * (1 + torch.linalg.vector_norm(grad) / Ls)
            progressed = (phi_k - phi_new) > eps * (1 + torch.abs(phi_k))
            stationary_b, progressed_b = torch.stack([stationary, progressed]).tolist()
            stall = 0 if progressed_b else stall + 1
            w = w_new
            if stationary_b or stall >= 2:
                break

        phi_star, x = dual.value_and_primal(w)
        return SubproblemResult(x=x, fun=-phi_star, weight=w, nit=nit)

    return solve_mk


# -- lane-batched solvers ------------------------------------------------------
#
# The batch solver (zfista_tpu_torch.parallel.batch) advances B independent
# solves together: every tensor below carries a leading lane axis.  The JAX
# package gets the same by jax.vmap over the single solvers, where XLA turns
# each lane's while_loop into one masked loop.  Eager PyTorch cannot vmap a
# host loop, so the m>=3 Newton solver is written over the lane axis with
# per-lane masks; m=1 and m=2 read nothing on the host and are the single
# solvers under torch.func.vmap.


def solve_small_linear_batched(K: Array, b: Array) -> Array:
    """:func:`solve_small_linear` over a leading lane axis: ``K (B, n, n)``,
    ``b (B, n)``.  Each lane pivots by its own ``argmax`` and swaps rows by
    ``gather``: the single solver's operations lane by lane, with the same
    inf/NaN on a singular system."""
    n = K.shape[-1]
    A = torch.cat([K, b[..., None]], dim=-1)
    idx = torch.arange(n, device=K.device)
    for k in range(n):
        mag = torch.where(idx < k, -math.inf, torch.abs(A[:, :, k]))
        p = torch.argmax(mag, dim=-1)[:, None]
        perm = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        A = torch.gather(A, 1, perm[:, :, None].expand(-1, -1, n + 1))
        row_scaled = A[:, k] / A[:, k, k : k + 1]
        factors = torch.where(idx == k, 0.0, A[:, :, k])
        A = A - factors[:, :, None] * row_scaled[:, None, :]
        A = torch.where((idx == k)[None, :, None], row_scaled[:, None, :], A)
    return A[:, :, n]


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
) -> Callable[..., SubproblemResult]:
    """Build ``solve(lr, F_old, y, f_y, jac_f_y, w0, live) ->
    SubproblemResult`` over a leading lane axis.

    ``g(x, *p)`` and ``prox_wsum_g(w, x, *p)`` are one lane's vector-form
    callables with the lane's params last (none when ``params``, every
    lane's with a leading axis, is ``None``).  ``live (B,)`` marks the lanes whose result
    is used: the m>=3 loops start with the others done, so they never run
    longer for them.  ``nit (B,)`` is each lane's own count, as the single
    solver counts it; ``fun`` is ``None`` when ``f_y`` is (m=1).
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

    # m >= 3: the single solve_mk's iteration over lanes.  Per lane: its
    # own done/stall/arc masks; a lane that is done keeps its w and adds
    # nothing to its nit.  Host reads: one per Newton round (does any lane
    # still iterate?) and one per arc-trial round (does any lane still
    # search?), whatever the number of lanes.
    newton_cap = min(max_iter, 30)

    def dual(f_y, jac_f_y, F_old, lr, y, *p) -> _Dual:
        return _make_dual(
            f_y, jac_f_y, F_old, lambda x: g(x, *p), lambda w, x: prox_wsum_g(w, x, *p),
            lr, y, deprecated,
        )

    v_value = _over_lanes(lambda w, *a: dual(*a).value(w), 6, params)
    v_vag = _over_lanes(lambda w, *a: dual(*a).value_and_grad(w), 6, params)
    v_vap = _over_lanes(lambda w, *a: dual(*a).value_and_primal(w), 6, params)
    v_hess = _over_lanes(
        torch.func.jacrev(lambda w, *a: dual(*a).grad(w)), 6, params
    )
    v_dot = torch.func.vmap(_VDOT)
    v_mv = torch.func.vmap(_DOT)

    def solve_mk_batched(lr, F_old, y, f_y, jac_f_y, w0, live) -> SubproblemResult:
        args = (f_y, jac_f_y, F_old, lr, y)
        dtype, dev = y.dtype, y.device
        B = y.shape[0]
        eps = _eps(dtype)
        delta = 1e-12 if dtype == torch.float64 else 1e-6
        stat_tol = max(tol, 100 * eps)
        eye = torch.eye(m, dtype=dtype, device=dev)
        zero1 = torch.zeros((B, 1), dtype=dtype, device=dev)

        lam_bound = lane_sum((jac_f_y * jac_f_y).flatten(1))
        Ls = torch.clamp_min(lr * lam_bound, 1.0)

        w = project_simplex(w0.to(dtype))
        nit = torch.ones(B, dtype=torch.int32, device=dev)
        stall = torch.zeros(B, dtype=torch.int32, device=dev)
        going = live
        for _ in range(newton_cap):
            if not bool(torch.any(going)):  # the one read per Newton round
                break
            phi_k, grad = v_vag(w, *args)
            H = v_hess(w, *args) + delta * eye

            w_pg = project_simplex(w - grad / Ls[:, None])
            fm = (w_pg > 0).to(dtype)
            d_active = (1.0 - fm) * (w_pg - w)
            K = torch.cat(
                [
                    torch.cat(
                        [
                            H * (fm[:, :, None] * fm[:, None, :])
                            + torch.diag_embed(1.0 - fm),
                            fm[:, :, None],
                        ],
                        dim=2,
                    ),
                    torch.cat([fm, zero1], dim=1)[:, None, :],
                ],
                dim=1,
            )
            rhs = torch.cat(
                [-(grad + v_mv(H, d_active)) * fm, -torch.sum(d_active, dim=1)[:, None]],
                dim=1,
            )
            d_newton = solve_small_linear_batched(K, rhs)[:, :m] + d_active

            d_pg = w_pg - w
            bad = (~torch.all(torch.isfinite(d_newton), dim=1)) | (v_dot(grad, d_newton) >= 0)
            d_first = torch.where(bad[:, None], d_pg, d_newton)
            slack = 4 * eps * (1 + torch.abs(phi_k))

            def accept(w_t, phi_t):
                moved = torch.any(w_t != w, dim=1)
                return moved & (phi_t <= phi_k + 1e-4 * v_dot(grad, w_t - w) + slack)

            def arc_search(d, searching, also=None):
                """Armijo along w(a) = P_simplex(w + a d), a = 1, 1/2, ... for
                the ``searching`` lanes, at most 40 trials each; one host read
                per round of trials.  ``also(ok)`` rides on the last read.
                Returns (ok, trials, w_t, phi_t, also's value)."""
                a = torch.ones(B, dtype=dtype, device=dev)
                w_t = project_simplex(w + d)
                phi_t = v_value(w_t, *args)
                ok = accept(w_t, phi_t)
                j = torch.ones(B, dtype=torch.int32, device=dev)
                trying = searching & ~ok
                while True:
                    flags = [torch.any(trying)]
                    if also is not None:
                        flags.append(torch.any(also(ok)))
                    more, *rest = torch.stack(flags).tolist()
                    if not more:
                        return ok, j, w_t, phi_t, (rest[0] if rest else None)
                    a = torch.where(trying, a * 0.5, a)
                    w_c = project_simplex(w + a[:, None] * d)
                    phi_c = v_value(w_c, *args)
                    ok_c = accept(w_c, phi_c)
                    w_t = torch.where(trying[:, None], w_c, w_t)
                    phi_t = torch.where(trying, phi_c, phi_t)
                    ok = torch.where(trying, ok_c, ok)
                    j = j + trying.to(torch.int32)
                    trying = trying & ~ok_c & (j < 40)

            # Retry along the projected gradient where the first arc failed
            # and was not already the projected gradient (``bad``).
            retry = lambda ok: going & ~ok & ~bad
            ok, n_ls, w_new, phi_new, any_retry = arc_search(d_first, going, retry)
            if any_retry:
                need = retry(ok)
                ok2, n2, w2, phi2, _ = arc_search(d_pg, need)
                ok = torch.where(need, ok2, ok)
                n_ls = n_ls + torch.where(need, n2, 0)
                w_new = torch.where(need[:, None], w2, w_new)
                phi_new = torch.where(need, phi2, phi_new)
            nit = nit + torch.where(going, n_ls + (m + 1), 0)

            gm = torch.linalg.vector_norm(w - w_pg, dim=1)
            stationary = gm <= stat_tol * (1 + torch.linalg.vector_norm(grad, dim=1) / Ls)
            progressed = (phi_k - phi_new) > eps * (1 + torch.abs(phi_k))
            moved = going & ok  # a failed arc is the floor: w stays, the lane stops
            stall = torch.where(moved, torch.where(progressed, 0, stall + 1), stall)
            w = torch.where(moved[:, None], w_new, w)
            going = moved & ~stationary & (stall < 2)

        phi_star, x = v_vap(w, *args)
        return SubproblemResult(x=x, fun=-phi_star, weight=w, nit=nit)

    return solve_mk_batched
