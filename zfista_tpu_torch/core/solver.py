r"""ISTA/FISTA with the generalized momentum factor, in eager PyTorch.

PyTorch-port counterpart of :mod:`zfista_tpu.core.solver`: the outer
iteration — backtracking line search, (multiobjective) subproblem,
convergence check on :math:`\|x^k - y^k\|_\infty`, and the generalized
momentum rule

.. math::

    t_{k+1} = \sqrt{t_k^2 - a\,t_k + b} + \tfrac12,\qquad
    y^{k+1} = x^k + \frac{t_k - 1}{t_{k+1}} (x^k - x^{k-1}).

Where the JAX package compiles the whole solve into one XLA program, the
port runs the same step eagerly: a :class:`State` of tensors on the
solve's device advanced by a Python function.  Data-dependent loops need a
host decision here:

* the backtracking line search is a host loop, one host read per trial
  (its accept test);
* the m>=3 dual's Newton loop and arc search are host loops
  (:mod:`zfista_tpu_torch.core.subproblem`); the m=2 bisection reads
  nothing;
* the drivers read the state's ``active`` flag once per ``check_every``
  steps (the while driver), once per step (the history driver) or once
  per ``iter_chunk`` steps (the chunk driver, from the host copy it keeps).

The fixed-step, single-objective step reads nothing at all.  Every step a
run takes is computed from the same inputs in the same order, so any
``check_every``, ``iter_chunk`` or ``initial_state`` continuation is
bitwise equal to the uninterrupted ``check_every=1`` solve.

On dense LASSO (:meth:`zfista_tpu_torch.models.Lasso.solve_fixed_step`)
the fixed-step step is its gradient and one launch of the fused CUDA
kernel (:func:`zfista_tpu_torch.ops.fused.lasso_step_tail`): the
soft-threshold prox, the momentum extrapolation and recursion, the
convergence test, the counters and the chunk loop's mask.  With
``tol_rel`` or ``warm_start`` the kernel computes the prox and the
extrapolation (:func:`zfista_tpu_torch.ops.fused.fused_prox_momentum`) and
the rest of the tail runs as eager launches.
"""

from __future__ import annotations

import time as _time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.result import TERMINATION_MESSAGES, SolveResult
from zfista_tpu_torch.core.subproblem import (
    _over_lanes,
    make_batch_subproblem_solver,
    make_subproblem_solver,
)
from zfista_tpu_torch.ops.fused import fused_prox_momentum, lasso_step_tail
from zfista_tpu_torch.ops.precision import dot_hp

# Private seam between the LASSO params callables and the step.  A
# params-style prox ``prox(w, x, p)`` carrying ``_SOFT_THRESHOLD_LAM_OF``
# computes ``soft_threshold(x, w * lam_of(p))``; once bound to its params
# (and normalized, with one objective) it carries ``_SOFT_THRESHOLD_LAM =
# lam``.  The fixed-lr nesterov step of a single-objective solve that
# skips ``F`` then computes its whole tail (the prox, the extrapolation,
# the convergence test, the counters, the chunk loop's mask) with one fused
# kernel launch instead of composing them.
_SOFT_THRESHOLD_LAM_OF = "_soft_threshold_lam_of"
_SOFT_THRESHOLD_LAM = "_soft_threshold_lam"

def _copy_soft_threshold_mark(src: Any, dst: Any) -> Any:
    lam = getattr(src, _SOFT_THRESHOLD_LAM, None)
    if lam is not None:
        setattr(dst, _SOFT_THRESHOLD_LAM, lam)
    return dst


class State(NamedTuple):
    """The carry of one solve: the JAX package's 12 fields, as tensors on
    the solve's device."""

    x: Array  # current accepted iterate (n,)
    y: Array  # extrapolated point (n,)
    F_x: Array  # F(x) = f(x) + g(x), (m,)
    lr: Array  # current learning rate (0-d)
    t: Array  # momentum t_k (0-d)
    w: Array  # dual warm start (m,)
    err: Array  # last ||x - y||_inf (0-d)
    sub_fun: Array  # last subproblem optimal value (0-d)
    nit: Array  # outer iterations completed (0-d int32)
    nit_internal: Array  # accumulated inner iterations (0-d int32)
    converged: Array  # 0-d bool
    failed: Array  # 0-d bool (line search exhausted)


class _LS(NamedTuple):
    """A line search's outcome.  ``done`` is on the host: the search's own
    reads decided it."""

    lr: Array
    done: bool
    x: Array
    F_x: Array
    w: Array
    sub_fun: Array
    nits: int | Array


def _make_step(
    f: Callable[[Array], Array],
    g: Callable[[Array], Array],
    jac_f: Callable[[Array], Array],
    prox_wsum_g: Callable[[Array, Array], Array],
    n_objectives: int,
    *,
    tol: float,
    tol_rel: float = 0.0,
    tol_internal: float,
    tol_internal_rel: float = 0.0,
    max_iter_internal: int,
    max_backtrack_iter: int,
    warm_start: bool,
    decay_rate: float,
    nesterov: bool,
    nesterov_ratio: tuple[float, float],
    deprecated: bool,
    verbose: bool = False,
    adaptive_restart: bool = False,
    project_momentum: bool = False,
    track_objective: bool = True,
    max_iter: int | None = None,
) -> Callable[[State], State]:
    """Build the outer-iteration step, as the JAX ``_make_step`` (all
    options fixed at build time).

    ``track_objective=False`` (legal only for single-objective fixed-step
    solves with no history or verbose consumer) skips ``F(x) = f(x) +
    g(x)``: nothing in that iteration reads ``F``, so the carried ``F_x``
    goes stale and the facade recomputes it once at the end.  The
    trajectory is bitwise the same.

    A returned step whose attribute ``masks_itself`` is true leaves a state
    that is not active (:func:`_active` at ``max_iter``) as it is, so a
    chunk loop runs it without :func:`_masked`.
    """
    m = n_objectives
    solve_sub = make_subproblem_solver(
        g,
        prox_wsum_g,
        m,
        tol=tol_internal,
        max_iter=max_iter_internal,
        deprecated=deprecated,
    )
    fixed_lr = decay_rate == 1
    a, b = nesterov_ratio
    lam = getattr(prox_wsum_g, _SOFT_THRESHOLD_LAM, None)
    fused = (
        fixed_lr
        and m == 1
        and not track_objective
        and nesterov
        and lam is not None
        and not adaptive_restart
        and not project_momentum
    )
    # The whole tail in one launch, for the options the kernel takes; with
    # the others the fused branch below composes the tail around the
    # kernel's prox and extrapolation.
    fused_tail = fused and not tol_rel and not warm_start
    # The only step that needs no f(y): the closed-form fixed-lr m == 1
    # step that skips the model value.
    need_f_y = not (fixed_lr and m == 1 and not track_objective)

    def trial(state: State, lr: Array, w: Array, f_y, jac_y):
        sub = solve_sub(lr, state.F_x, state.y, f_y, jac_y, w)
        f_t = f(sub.x)
        return sub, f_t, f_t + g(sub.x)

    def accept_test(state: State, f_y, f_t, F_t, sub_fun) -> Array:
        slack = sub_fun + tol_internal
        if tol_internal_rel:
            # Opt-in slack proportional to the comparison's own magnitude
            # (default 0: the reference accept test, bitwise).
            ref = f_y if deprecated else state.F_x
            slack = slack + tol_internal_rel * torch.abs(ref)
        lhs = f_t - f_y if deprecated else F_t - state.F_x
        # NaN-safe: comparisons with NaN are False => reject.
        return torch.all(lhs <= slack)

    def line_search(state: State, f_y, jac_y) -> _LS:
        if fixed_lr:
            # decay_rate == 1: a single subproblem solve, accepted
            # unconditionally.
            if track_objective:
                sub, _, F_t = trial(state, state.lr, state.w, f_y, jac_y)
                sub_fun = sub.fun
            else:
                sub = solve_sub(state.lr, state.F_x, state.y, f_y, jac_y, state.w)
                F_t, sub_fun = state.F_x, state.sub_fun  # stale, never read
            w = sub.weight if warm_start else state.w
            return _LS(state.lr, True, sub.x, F_t, w, sub_fun, sub.nit)

        lr, w, nits = state.lr, state.w, 0
        x, F_t, sub_fun = state.x, state.F_x, torch.zeros_like(state.t)
        for _ in range(max_backtrack_iter):
            sub, f_t, F_t = trial(state, lr, w, f_y, jac_y)
            ok = accept_test(state, f_y, f_t, F_t, sub.fun)
            w = sub.weight if warm_start else w
            x, sub_fun, nits = sub.x, sub.fun, nits + sub.nit
            if bool(ok):  # the one host read per trial
                return _LS(lr, True, x, F_t, w, sub_fun, nits)
            lr = lr * decay_rate
        return _LS(lr, False, x, F_t, w, sub_fun, nits)

    if fused_tail:

        def tail_step(state: State) -> State:
            tail = lasso_step_tail(
                state.y, jac_f(state.y)[0], state.x, state.t, state.lr, lam,
                state.err, state.nit, state.nit_internal, state.converged,
                state.failed, a=a, b=b, tol=tol, max_iter=max_iter,
            )
            return state._replace(**tail._asdict())

        tail_step.masks_itself = True
        return tail_step

    def step(state: State) -> State:
        dev = state.x.device
        f_y = f(state.y) if need_f_y else None
        jac_y = jac_f(state.y)

        if fused:
            t_k = state.t
            t_new = torch.sqrt(t_k**2 - a * t_k + b) + 0.5
            gamma = (t_k - 1) / t_new
            # x = soft(y - lr*grad, lr*lam): the closed-form subproblem at
            # the prox weight lr, with the extrapolation in the same pass.
            x, y_new = fused_prox_momentum(
                state.y, jac_y[0], state.x, state.lr, state.lr * lam, gamma
            )
            w = torch.ones_like(state.w) if warm_start else state.w
            ls = _LS(state.lr, True, x, state.F_x, w, state.sub_fun, 1)
        else:
            ls = line_search(state, f_y, jac_y)

        err = torch.amax(torch.abs(ls.x - state.y))
        if tol_rel:
            # Opt-in iterate-scaled criterion: ||x - y||_inf < tol +
            # tol_rel * ||x||_inf (0 compiles to the reference test).
            converged_now = err < tol + tol_rel * torch.amax(torch.abs(ls.x))
        else:
            converged_now = err < tol
        nit_internal = state.nit_internal + ls.nits

        if not ls.done:
            # Line search exhausted: freeze at the last accepted point; nit
            # does not advance, the inner iterations spent still count.
            if verbose:
                _print_row(state, max_iter, state.nit, nit_internal, err, ls)
            return state._replace(
                nit_internal=nit_internal,
                converged=torch.zeros((), dtype=torch.bool, device=dev),
                failed=torch.ones((), dtype=torch.bool, device=dev),
            )

        if fused:
            pass  # t_new and y_new came with the kernel's x
        elif nesterov:
            t_k = state.t
            if adaptive_restart:
                # O'Donoghue & Candes gradient-scheme restart: reset the
                # momentum when the step opposes the previous direction.
                osc = dot_hp(state.y - ls.x, ls.x - state.x) > 0
                t_k = torch.where(osc, torch.ones_like(t_k), t_k)
            t_new = torch.sqrt(t_k**2 - a * t_k + b) + 0.5
            gamma = (t_k - 1) / t_new
            y_new = ls.x + gamma * (ls.x - state.x)
            if project_momentum:
                # Feasible extrapolation: y through the zero-weight prox
                # (for a box-constrained problem, the box projection).
                y_new = prox_wsum_g(
                    torch.zeros((m,), dtype=y_new.dtype, device=dev), y_new
                )
        else:
            t_new = state.t
            y_new = ls.x

        nit_new = state.nit + 1
        if verbose:
            _print_row(state, max_iter, nit_new, nit_internal, err, ls)
        # Converged step: keep the old y/t (the JAX step's freeze).
        return State(
            x=ls.x,
            y=torch.where(converged_now, state.y, y_new),
            F_x=ls.F_x,
            lr=ls.lr,
            t=torch.where(converged_now, state.t, t_new),
            w=ls.w,
            err=err,
            sub_fun=ls.sub_fun,
            nit=nit_new,
            nit_internal=nit_internal,
            converged=converged_now,
            failed=state.failed,
        )

    return step


def _make_batch_step(
    f: Callable[..., Array],
    g: Callable[..., Array],
    jac_f: Callable[..., Array],
    prox_wsum_g: Callable[..., Array],
    n_objectives: int,
    params: Any,
    *,
    tol: float,
    tol_rel: float = 0.0,
    tol_internal: float,
    tol_internal_rel: float = 0.0,
    max_iter_internal: int,
    max_backtrack_iter: int,
    warm_start: bool,
    decay_rate: float,
    nesterov: bool,
    nesterov_ratio: tuple[Any, Any],
    deprecated: bool,
    adaptive_restart: bool = False,
    project_momentum: bool = False,
    track_objective: bool = True,
    max_iter: int,
) -> Callable[[State], State]:
    """The outer-iteration step of B independent solves at once: every
    :class:`State` field carries a leading lane axis.

    ``f(x, *p)``, ``g(x, *p)``, ``jac_f(x, *p)`` and ``prox_wsum_g(w, x,
    *p)`` are ONE lane's vector-form callables (:func:`_normalize_problem`)
    with the lane's params last; they run over all lanes by
    ``torch.func.vmap``, with ``params`` (leading lane axis) as their last
    argument, or none when it is ``None``.  ``nesterov_ratio`` is a pair
    of floats or of ``(B,)`` tensors (a momentum pair per lane).

    Per lane it computes what :func:`_make_step` computes, with the host
    decisions as lane masks: the backtracking line search runs rounds of
    trials while any lane still searches (one host read per round), each
    lane with its own ``lr``, and a lane that exhausts ``max_backtrack_iter``
    fails alone.  Lanes that are not active (converged, failed or at
    ``max_iter``) enter the trial loop already done, and the step returns
    their state as it was: the step masks itself.  There is no fused LASSO
    tail here.
    """
    m = n_objectives
    solve_sub = make_batch_subproblem_solver(
        g,
        prox_wsum_g,
        m,
        params,
        tol=tol_internal,
        max_iter=max_iter_internal,
        deprecated=deprecated,
    )
    v_f = _over_lanes(f, 1, params)
    v_g = _over_lanes(g, 1, params)
    v_jac = _over_lanes(jac_f, 1, params)
    v_prox = _over_lanes(prox_wsum_g, 2, params)
    v_dot = torch.func.vmap(dot_hp)
    fixed_lr = decay_rate == 1
    a, b = nesterov_ratio
    need_f_y = not (fixed_lr and m == 1 and not track_objective)

    def trial(state: State, lr, w, f_y, jac_y, live):
        sub = solve_sub(lr, state.F_x, state.y, f_y, jac_y, w, live)
        f_t = v_f(sub.x)
        return sub, f_t, f_t + v_g(sub.x)

    def accept_test(state: State, f_y, f_t, F_t, sub_fun) -> Array:
        slack = (sub_fun + tol_internal)[:, None]
        if tol_internal_rel:
            ref = f_y if deprecated else state.F_x
            slack = slack + tol_internal_rel * torch.abs(ref)
        lhs = f_t - f_y if deprecated else F_t - state.F_x
        return torch.all(lhs <= slack, dim=1)

    def line_search(state: State, f_y, jac_y, active) -> _LS:
        if fixed_lr:
            if track_objective:
                sub, _, F_t = trial(state, state.lr, state.w, f_y, jac_y, active)
                sub_fun = sub.fun
            else:
                sub = solve_sub(state.lr, state.F_x, state.y, f_y, jac_y, state.w, active)
                F_t, sub_fun = state.F_x, state.sub_fun  # stale, never read
            w = sub.weight if warm_start else state.w
            return _LS(state.lr, torch.ones_like(active), sub.x, F_t, w, sub_fun, sub.nit)

        lr, w, nits = state.lr, state.w, torch.zeros_like(state.nit)
        x, F_t, sub_fun = state.x, state.F_x, torch.zeros_like(state.t)
        searching, done = active, ~active
        for k in range(max_backtrack_iter):
            if k and not bool(torch.any(searching)):  # one host read per round
                break
            sub, f_t, F_c = trial(state, lr, w, f_y, jac_y, searching)
            ok = accept_test(state, f_y, f_t, F_c, sub.fun)
            s = searching[:, None]
            if warm_start:
                w = torch.where(s, sub.weight, w)
            x = torch.where(s, sub.x, x)
            F_t = torch.where(s, F_c, F_t)
            sub_fun = torch.where(searching, sub.fun, sub_fun)
            nits = nits + torch.where(searching, sub.nit, 0)
            done = done | (searching & ok)
            lr = torch.where(searching & ~ok, lr * decay_rate, lr)
            searching = searching & ~ok
        return _LS(lr, done, x, F_t, w, sub_fun, nits)

    def step(state: State) -> State:
        active = _active(state, max_iter)
        f_y = v_f(state.y) if need_f_y else None
        jac_y = v_jac(state.y)
        ls = line_search(state, f_y, jac_y, active)

        err = torch.amax(torch.abs(ls.x - state.y), dim=1)
        if tol_rel:
            converged_now = err < tol + tol_rel * torch.amax(torch.abs(ls.x), dim=1)
        else:
            converged_now = err < tol
        nit_internal = state.nit_internal + ls.nits

        if nesterov:
            t_k = state.t
            if adaptive_restart:
                osc = v_dot(state.y - ls.x, ls.x - state.x) > 0
                t_k = torch.where(osc, torch.ones_like(t_k), t_k)
            t_new = torch.sqrt(t_k**2 - a * t_k + b) + 0.5
            gamma = (t_k - 1) / t_new
            y_new = ls.x + gamma[:, None] * (ls.x - state.x)
            if project_momentum:
                y_new = v_prox(torch.zeros_like(state.w), y_new)
        else:
            t_new = state.t
            y_new = ls.x

        # Converged step: keep the old y/t (the JAX step's freeze).
        new = State(
            x=ls.x,
            y=torch.where(converged_now[:, None], state.y, y_new),
            F_x=ls.F_x,
            lr=ls.lr,
            t=torch.where(converged_now, state.t, t_new),
            w=ls.w,
            err=err,
            sub_fun=ls.sub_fun,
            nit=state.nit + 1,
            nit_internal=nit_internal,
            converged=converged_now,
            failed=state.failed,
        )
        # Per lane: the step where it was active and accepted a trial; where
        # the line search was exhausted, a freeze at the last accepted point
        # (nit does not advance, the inner iterations spent still count,
        # failed); elsewhere the state as it was.
        moved = active & ls.done
        out = State(
            *(torch.where(moved.view(-1, *(1,) * (u.dim() - 1)), u, v) for u, v in zip(new, state))
        )
        return out._replace(
            nit_internal=torch.where(active, nit_internal, state.nit_internal),
            failed=state.failed | (active & ~ls.done),
        )

    step.masks_itself = True
    return step


def _print_row(state: State, max_iter, nit, nit_internal, err, ls: _LS) -> None:
    """One verbose row (the JAX step's five columns), or none when the
    step ran on a frozen state (a masked chunk's discarded step)."""
    frozen = bool(state.converged | state.failed) or (
        max_iter is not None and int(state.nit) >= max_iter
    )
    if not frozen:
        print(
            f"|{int(nit):>6}|{int(nit_internal):>8}|{float(err):>+13.4e}"
            f"|{float(ls.sub_fun):>+13.4e}|{float(ls.lr):>10.2e}|",
            flush=True,
        )


def init_state(x0: Array, F0: Array, n_objectives: int, lr: Array) -> State:
    dtype, device = x0.dtype, x0.device
    m = n_objectives

    def scalar(v: Any, dt: torch.dtype = dtype) -> Array:
        return torch.as_tensor(v, dtype=dt, device=device)

    return State(
        x=x0,
        y=x0,
        F_x=F0,
        lr=scalar(lr),
        t=scalar(1.0),
        w=torch.full((m,), 1.0 / m, dtype=dtype, device=device),
        err=scalar(float("inf")),
        sub_fun=scalar(0.0),
        nit=scalar(0, torch.int32),
        nit_internal=scalar(0, torch.int32),
        converged=scalar(False, torch.bool),
        failed=scalar(False, torch.bool),
    )


def _active(state: State, max_iter: int) -> Array:
    return ~(state.converged | state.failed) & (state.nit < max_iter)


def _masked(step: Callable[[Any], Any], active: Callable[[Any], Array]):
    """``step`` with its result selected against the input where the input
    is not ``active`` (one ``torch.where`` per field).  The mask SELECTS,
    never multiplies: a frozen step still runs, and whatever it computes,
    NaN included, never reaches the carry."""

    def masked_step(c: Any) -> Any:
        a = active(c)
        new = step(c)
        return type(c)(*(torch.where(a, n, o) for n, o in zip(new, c)))

    return masked_step


def _chunk_body(step: Callable[[Any], Any], active: Callable[[Any], Array]):
    """``step`` as a chunk loop runs it: masked, unless it masks itself
    (with the loop's own ``active`` rule; see :func:`_make_step`)."""
    return step if getattr(step, "masks_itself", False) else _masked(step, active)


def run_masked(
    step: Callable[[Any], Any],
    carry: Any,
    active: Callable[[Any], Array],
    check_every: int,
) -> Any:
    """Advance the NamedTuple ``carry`` by ``step`` while ``active``,
    reading the device's flag on the host once every ``check_every``
    steps.

    Inside a chunk each step is masked (:func:`_chunk_body`): a carry that
    stopped mid-chunk stays frozen, so the result is BITWISE IDENTICAL to
    ``check_every=1``, step count included.  The chunk enqueues its steps
    without waiting for the device, which is what the chunking buys on a
    CUDA card.
    """
    # A chunk is entered only from an active carry, where the mask is the
    # identity: with one step per chunk it is left out.
    body = step if check_every == 1 else _chunk_body(step, active)
    while bool(active(carry)):  # the one host read per chunk
        for _ in range(check_every):
            carry = body(carry)
    return carry


def make_while_driver(
    step: Callable[[State], State], max_iter: int, check_every: int = 1
) -> Callable[[State], State]:
    """Run ``step`` until the state is inactive (converged, failed or at
    ``max_iter``), reading the convergence flag on the host once every
    ``check_every`` steps (:func:`run_masked`)."""

    def run(state: State) -> State:
        return run_masked(step, state, lambda s: _active(s, max_iter), check_every)

    return run


def _run_history(step, state: State, max_iter: int, chunk: int):
    """The history driver: step while active, recording ``(x, F_x, err)``
    of every step that ran and did not fail the line search.

    The JAX scan driver runs whole chunks of masked steps; here the host
    reads ``active`` before every step instead, so a frozen state is never
    stepped (each frozen backtracking step would re-run its line search).
    The steps recorded, and the final state, are the same.  Records are
    copied to the host once per ``chunk`` steps, as numpy rows.
    """
    xs, fs, errs, pending = [], [], [], []

    def flush():
        if pending:
            x, F, e, rec = (torch.stack(v).cpu().numpy() for v in zip(*pending))
            xs.extend(x[rec])
            fs.extend(F[rec])
            errs.extend(e[rec])
            pending.clear()

    while bool(_active(state, max_iter)):
        state = step(state)
        pending.append((state.x, state.F_x, state.err, ~state.failed))
        if len(pending) >= chunk:
            flush()
    flush()
    return state, xs, fs, errs


def _bind_params(
    f: Callable[..., Any],
    g: Callable[..., Any],
    jac_f: Callable[..., Array] | None,
    prox_wsum_g: Callable[..., Array],
    p: Any,
) -> tuple[Any, Any, Any, Any]:
    """Bind a ``params`` tuple as the trailing argument of the problem
    callables."""
    fb = lambda x: f(x, p)
    gb = lambda x: g(x, p)
    jacb = (lambda x: jac_f(x, p)) if jac_f is not None else None
    proxb = lambda w, x: prox_wsum_g(w, x, p)
    lam_of = getattr(prox_wsum_g, _SOFT_THRESHOLD_LAM_OF, None)
    if lam_of is not None:
        setattr(proxb, _SOFT_THRESHOLD_LAM, lam_of(p))
    return fb, gb, jacb, proxb


def _normalize_problem(
    f: Callable[..., Any],
    g: Callable[..., Any],
    jac_f: Callable[..., Array] | None,
    prox_wsum_g: Callable[..., Array],
    x0: Array,
    *p: Any,
) -> tuple[Any, Any, Any, Any, int, bool]:
    """Normalize user callables to vector form: f,g -> (m,), jac -> (m,n),
    prox(w_vec, x). Returns (f, g, jac, prox, m, scalar_mode).

    ``p`` are trailing arguments that every callable takes and passes on
    (the batch solver passes one lane's params; the single solve binds its
    params first and passes none).  One eager call of ``f`` at ``x0``
    gives the output shape (the JAX version traces ``jax.eval_shape``).
    The fused-step mark is carried over to a single-objective prox only."""
    out = f(x0, *p)
    scalar_mode = out.dim() == 0
    if scalar_mode:
        m = 1
        f_v = lambda x, *q: torch.reshape(f(x, *q), (1,))
        g_v = lambda x, *q: torch.reshape(g(x, *q), (1,))
        if jac_f is None:
            grad = torch.func.grad(lambda z, *q: torch.sum(f(z, *q)))
            jac_v = lambda x, *q: torch.reshape(grad(x, *q), (1, -1))
        else:
            jac_v = lambda x, *q: torch.reshape(jac_f(x, *q), (1, -1))
        prox_v = lambda w, x, *q: prox_wsum_g(w[0], x, *q)
    else:
        m = out.shape[0]
        f_v = f
        g_v = g
        if jac_f is None:
            jac_v = torch.func.jacfwd(f)
        else:
            jac_v = lambda x, *q: torch.reshape(jac_f(x, *q), (m, -1))
        if m == 1:
            # Reference convention: scalar weight when there is one objective.
            prox_v = lambda w, x, *q: prox_wsum_g(w[0], x, *q)
        else:
            prox_v = prox_wsum_g
    if m == 1:
        prox_v = _copy_soft_threshold_mark(prox_wsum_g, prox_v)
    return f_v, g_v, jac_v, prox_v, m, scalar_mode


def data_device(device: Any) -> torch.device:
    """The device that data given as numpy arrays or Python values go to:
    ``device`` (the entry points' default is ``"cuda"``).  Raises if that is
    a CUDA device and there is none: nothing falls back to the CPU; pass
    ``device="cpu"`` or CPU tensors for a CPU solve."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zfista_tpu_torch: no CUDA device for data given as numpy or Python "
            "values; pass device='cpu' (or CPU tensors) to solve on the CPU"
        )
    return dev


def _solve_device(x0: Any, params: Any, device: Any) -> torch.device:
    """The solve's device, from the tensors passed in: ``x0``'s if it is a
    tensor, else that of the first tensor in ``params``, else ``device``."""
    if isinstance(x0, torch.Tensor):
        return x0.device
    for leaf in params if isinstance(params, (tuple, list)) else (params,):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return data_device(device)


def _to_device(v: Any, dev: torch.device) -> Array:
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.tensor(np.asarray(v), device=dev)


def minimize_proximal_gradient(
    f: Callable[[Array], Any],
    g: Callable[[Array], Any],
    jac_f: Callable[[Array], Array] | None,
    prox_wsum_g: Callable[[Any, Array], Array],
    x0: Any,
    lr: float = 1,
    tol: float = 1e-5,
    tol_rel: float = 0.0,
    tol_internal: float = 1e-12,
    tol_internal_rel: float = 0.0,
    max_iter: int = 1000000,
    max_iter_internal: int = 100000,
    max_backtrack_iter: int = 100,
    warm_start: bool = False,
    decay_rate: float = 0.5,
    nesterov: bool = False,
    nesterov_ratio: tuple[float, float] = (0, 0.25),
    return_all: bool = False,
    verbose: bool = False,
    deprecated: bool = False,
    history_chunk: int = 512,
    initial_state: State | None = None,
    check_every: int | None = None,
    iter_chunk: int | None = None,
    adaptive_restart: bool = False,
    project_momentum: bool = False,
    params: Any = None,
    device: Any = "cuda",
) -> SolveResult:
    r"""Minimize :math:`F(x) = f(x) + g(x)` (scalar- or vector-valued).

    The JAX package's facade, with its signature and defaults, over eager
    PyTorch.  ``f``, ``g``, ``jac_f`` and ``prox_wsum_g`` take and return
    tensors; ``jac_f=None`` derives the Jacobian with ``torch.func``.
    ``params`` (optional tuple) is passed as every callable's trailing
    argument.  The solve runs on ``x0``'s device when ``x0`` is a tensor,
    else on that of the first tensor in ``params``, else on ``device``
    (default ``"cuda"``; a machine with no card raises, and
    ``device="cpu"`` asks for the CPU); every tensor of the solve stays
    there.

    Options, as in the JAX package: backtracking (``decay_rate < 1``) or a
    fixed step (``decay_rate == 1``), ``max_backtrack_iter``,
    ``warm_start``, ISTA or FISTA (``nesterov``) with any
    ``nesterov_ratio``, ``adaptive_restart``, ``project_momentum``,
    ``deprecated``, ``tol``/``tol_rel``, ``tol_internal``/
    ``tol_internal_rel``, ``return_all`` (histories ``allvecs``,
    ``allfuns``, ``allerrs`` of every step that did not fail its line
    search, starting at the resume point on a resumed solve), ``verbose``
    (a five-column row per step), ``initial_state`` (resume from a
    :class:`State`, tensors or numpy, e.g. ``res.state``; pass the same
    options), ``check_every`` and ``iter_chunk``.

    ``check_every=None`` picks 64 for a single-objective fixed-step solve
    on a CUDA device (one host read of the convergence flag per 64 steps)
    and 1 elsewhere.  ``iter_chunk`` runs at most that many steps between
    host copies of the state; when the device faults inside a chunk, the
    solve returns the last chunk's host copy with ``success=False``,
    status 2 and a "device fault" message, without touching the device
    again.  Every ``check_every``/``iter_chunk`` gives bitwise the result
    of ``check_every=1``.

    Returns a :class:`SolveResult` with fields
    ``x, fun, success, status, message, nit, nit_internal, time, weight``
    as numpy values, and ``state``, the final :class:`State` as numpy.
    """
    if deprecated:
        warnings.warn(
            "The `deprecated` subproblem condition has no global-convergence "
            "proof; prefer the default condition.",
            stacklevel=2,
        )
    if check_every is not None:
        check_every = int(check_every)
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
    if tol_rel < 0:
        raise ValueError(f"tol_rel must be >= 0, got {tol_rel}")
    if tol_internal_rel < 0:
        raise ValueError(f"tol_internal_rel must be >= 0, got {tol_internal_rel}")
    if iter_chunk is not None and int(iter_chunk) < 1:
        raise ValueError(f"iter_chunk must be >= 1, got {iter_chunk}")
    start = _time.perf_counter()

    dev = _solve_device(x0, params, device)
    x0 = torch.as_tensor(x0, device=dev)
    if not x0.is_floating_point():
        x0 = x0.to(torch.get_default_dtype())
    # The host copy of x0 for the result, taken before the device does
    # any work (a faulted solve must not read the device again).
    x0_res = x0.detach().cpu().numpy().copy()
    if params is not None:
        f_b, g_b, jac_b, prox_b = _bind_params(f, g, jac_f, prox_wsum_g, params)
    else:
        f_b, g_b, jac_b, prox_b = f, g, jac_f, prox_wsum_g
    f_v, g_v, jac_v, prox_v, m, scalar_mode = _normalize_problem(
        f_b, g_b, jac_b, prox_b, x0
    )

    if check_every is None:
        # The JAX rule with "device is CUDA" for "backend is TPU": chunking
        # keeps a CUDA card fed between host reads; on the CPU the step
        # itself is the host's work and per-step checking stops earliest.
        check_every = (
            64
            if (
                m == 1
                and decay_rate == 1
                and not return_all
                and not verbose
                and iter_chunk is None
                and dev.type == "cuda"
            )
            else 1
        )
    # Single-objective fixed-step solves with no per-iteration consumer of
    # F skip the objective in the step and recompute it once at the end.
    skip_F = decay_rate == 1 and m == 1 and not return_all and not verbose
    max_iter = int(max_iter)
    if iter_chunk is not None and not return_all:
        iter_chunk = int(iter_chunk)
        if check_every > 1 and iter_chunk < max_iter:
            warnings.warn(
                "check_every > 1 is ignored when iter_chunk bounds the "
                "kernel (the host-chunked driver re-dispatches every "
                "iter_chunk steps).",
                stacklevel=2,
            )
            check_every = 1

    step = _make_step(
        f_v,
        g_v,
        jac_v,
        prox_v,
        m,
        tol=tol,
        tol_rel=float(tol_rel),
        tol_internal=tol_internal,
        tol_internal_rel=float(tol_internal_rel),
        max_iter_internal=int(max_iter_internal),
        max_backtrack_iter=int(max_backtrack_iter),
        warm_start=warm_start,
        decay_rate=decay_rate,
        nesterov=nesterov,
        nesterov_ratio=tuple(nesterov_ratio),
        deprecated=deprecated,
        verbose=verbose,
        adaptive_restart=bool(adaptive_restart),
        project_momentum=bool(project_momentum),
        track_objective=not skip_F,
        max_iter=max_iter,
    )

    if verbose:
        hdr = ["niter", "nit int", "max|xk - yk|", "subprob func", "lr"]
        widths = [6, 8, 13, 13, 10]
        print("|" + "|".join(h.center(w) for h, w in zip(hdr, widths)) + "|")
        print("|" + "|".join("-" * w for w in widths) + "|")

    if initial_state is not None:
        state = State(*(_to_device(v, dev) for v in initial_state))
    else:
        lr_t = torch.as_tensor(lr, dtype=x0.dtype, device=dev)
        state = init_state(x0, f_v(x0) + g_v(x0), m, lr_t)

    device_faulted = False
    allvecs = allfuns = allerrs = None
    if return_all:
        if check_every != 1:
            warnings.warn(
                "check_every > 1 is ignored when return_all=True (the "
                "history driver records every iteration).",
                stacklevel=2,
            )
        chunk = int(history_chunk)
        if chunk < 1:
            raise ValueError(f"history_chunk must be >= 1, got {chunk}")
        if iter_chunk is not None:
            chunk = min(chunk, int(iter_chunk))
        # The history head: the resume iterate on a resumed solve, so that
        # allvecs[k] and allfuns[k] stay paired.
        head_x = x0_res if initial_state is None else state.x.cpu().numpy()
        head_F = state.F_x.cpu().numpy()
        state, xs, fs, allerrs = _run_history(step, state, max_iter, chunk)
        allvecs = [head_x] + xs
        allfuns_arr = [head_F] + fs
        if scalar_mode:
            allfuns = [float(v[0]) for v in allfuns_arr]
        else:
            allfuns = allfuns_arr
    elif iter_chunk is not None and iter_chunk < max_iter:
        # Host-chunked driving: at most iter_chunk masked steps between
        # host copies of the state.  Frozen steps no-op, so the result is
        # bitwise the while driver's.  The host copy taken after each good
        # chunk is the partial result if the device faults in the next.
        masked = _chunk_body(step, lambda s: _active(s, max_iter))
        host = state_to_numpy(state)
        while bool(_active(host, max_iter)):
            try:
                for _ in range(iter_chunk):
                    state = masked(state)
                host = state_to_numpy(state)
            except torch.AcceleratorError as exc:  # how CUDA faults surface
                warnings.warn(
                    f"device fault after {int(host.nit)} iterations — "
                    f"returning partial result (success=False). Original "
                    f"error: {type(exc).__name__}: {str(exc)[:200]}",
                    stacklevel=2,
                )
                # Stay off the device from here on: the partial result is
                # the host copy.  Under skip_F its F_x was never updated,
                # so NaN is the honest objective.
                host = host._replace(failed=np.asarray(True))
                if skip_F:
                    host = host._replace(F_x=np.full_like(host.F_x, np.nan))
                device_faulted = True
                break
    else:
        state = make_while_driver(step, max_iter, check_every)(state)

    if not device_faulted:
        if skip_F:
            # The step skips F (see _make_step): recompute it once at the end.
            state = state._replace(F_x=f_v(state.x) + g_v(state.x))
        host = state_to_numpy(state)
    elapsed = _time.perf_counter() - start

    fun = host.F_x[0] if scalar_mode else host.F_x
    res = SolveResult(
        x0=x0_res,
        tol=tol,
        tol_rel=tol_rel,
        tol_internal=tol_internal,
        tol_internal_rel=tol_internal_rel,
        nesterov=nesterov,
        nesterov_ratio=nesterov_ratio,
        x=host.x,
        fun=np.asarray(fun),
        weight=host.w,
        nit=int(host.nit),
        nit_internal=int(host.nit_internal),
        lr=float(host.lr),
        error_criterion=float(host.err),
        time=elapsed,
        allvecs=allvecs,
        allfuns=allfuns,
        allerrs=allerrs,
        state=host,
    )
    if bool(host.failed):
        res.success = False
        res.status = 2
        # A device fault is not a line-search failure.
        res.message = (
            f"Error: device fault — partial result at iteration "
            f"{int(host.nit)} (success=False)."
            if device_faulted
            else TERMINATION_MESSAGES[2]
        )
    elif bool(host.converged):
        res.success = True
        res.status = 1
        res.message = TERMINATION_MESSAGES[1]
    else:
        res.success = False
        res.status = 0
        res.message = TERMINATION_MESSAGES[0]
        warnings.warn(res.message, stacklevel=2)
    return res


def state_to_numpy(state: State) -> State:
    """``state`` with every field copied to the host as a numpy array."""
    return State(*(v.detach().cpu().numpy() for v in state))
