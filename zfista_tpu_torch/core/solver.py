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

* the backtracking line search of the per-iteration step is a host loop,
  one host read per trial (its accept test), and the m>=3 dual's Newton
  loop reads once per Newton iteration
  (:mod:`zfista_tpu_torch.core.subproblem`; its arc searches and the m=2
  bisection read nothing).  A solve chunked by ``check_every > 1`` (and
  not ``verbose``, ``return_all``, ``iter_chunk`` or feature-sharded)
  runs instead the carried search: at m <= 2 one trial per step, the
  search's state (:class:`_Search`) in the carry and the accept test
  selected on the device; at m >= 3 (the fixed step too) one Newton
  iteration of the current trial per step (:class:`_NewtonSearch`), the
  counterpart of the JAX package's ``lax.while_loop`` inside the step;
  so does ``return_all`` on a card;
* the drivers read the state's ``active`` flag once per ``check_every``
  steps (the while driver), once per step or, for a step that reads
  nothing on a card, once per replayed graph of a few steps (the history
  driver, :func:`_history_steps`), or once per ``iter_chunk`` steps (the
  chunk driver, from the host copy it keeps).

The fixed-step step and the carried trial read nothing at all.  Every step
a run takes is computed from the same inputs in the same order, so any
``check_every``, ``iter_chunk`` or ``initial_state`` continuation is
bitwise equal to the uninterrupted ``check_every=1`` solve.  On a card the
chunks of every step that reads nothing (the one-launch LASSO-family
step below, the generic fixed step at m <= 2, the carried search, and the
batch's fixed-lr step at m <= 2 and per-lane carried search) run as
replayed CUDA graphs (:func:`run_graphed`; with history,
:func:`run_recorded`), the counterpart of the JAX package's one device
program per chunk.

On dense LASSO (:meth:`zfista_tpu_torch.models.Lasso.solve_fixed_step`)
the fixed-step step is its gradient and one launch of the fused CUDA
kernel (:func:`zfista_tpu_torch.ops.fused.lasso_step_tail`): the
soft-threshold prox, the momentum extrapolation and recursion, the
convergence test, the counters and the chunk loop's mask.  With
``tol_rel`` or ``warm_start`` the kernel computes the prox and the
extrapolation (:func:`zfista_tpu_torch.ops.fused.fused_prox_momentum`) and
the rest of the tail runs as launches of their own.

A start ``x0`` that is this rank's block of a feature-sharded iterate
(tagged by :mod:`zfista_tpu_torch.parallel.sharding`, as
``Lasso.solve_fixed_step`` lays it out from its operator, or a zoo
``Problem`` built with ``sharding=``) makes the solve feature-sharded, at
any objective count: the problem callables reduce over the ``"model"``
ranks themselves, the step all-reduces its convergence test (``max|x −
y|``, NaN carried) and its other sums over features (the m = 2
bisection's and the m >= 3 Newton dual's too,
:mod:`zfista_tpu_torch.core.subproblem`), and the facade returns the
whole ``x`` on every rank.  Such a step runs on the eager host-loop
drivers: Gloo's collectives are not captured into CUDA graphs, so it is
never ``capturable`` and has no ``carried_search``.  At m = 1 it takes the
composed tail around ``fused_prox_momentum``: the one-launch tail decides
convergence inside the kernel from a block's max, and ranks would stop on
different steps.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time as _time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.result import TERMINATION_MESSAGES, SolveResult
from zfista_tpu_torch.core.subproblem import (
    Newton,
    NewtonParts,
    _over_lanes,
    make_batch_subproblem_solver,
    make_subproblem_solver,
)
from zfista_tpu_torch.ops import fused, tv_cuda
from zfista_tpu_torch.ops.fused import fused_prox_momentum, lasso_step_tail
from zfista_tpu_torch.ops.precision import dot_hp
from zfista_tpu_torch.utils import profiling
from zfista_tpu_torch.utils.profiling import annotate, device_to_host, read_flag

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
    """A line search's outcome.  ``done`` is a host bool where the search
    ran as a host loop (its own reads decided it), a 0-d bool tensor for a
    carried trial (its accept test, never read on the host)."""

    lr: Array
    done: bool | Array
    x: Array
    F_x: Array
    w: Array
    sub_fun: Array
    nits: int | Array


class _Search(NamedTuple):
    """The carry of a solve whose backtracking line search runs as carried
    trials, one a step: the 12 :class:`State` fields, then the search's
    own (the JAX ``line_search`` loop state, carried across steps).  In a
    batch every field has the leading lane axis."""

    x: Array
    y: Array
    F_x: Array
    lr: Array
    t: Array
    w: Array
    err: Array
    sub_fun: Array
    nit: Array
    nit_internal: Array
    converged: Array
    failed: Array
    k: Array  # trials taken in this iteration (0-d int32)
    lr_try: Array  # the next trial's lr (0-d)
    w_try: Array  # the next trial's dual warm start (m,)
    spent: Array  # inner iterations of this iteration's trials so far (0-d int32)

    @classmethod
    def start(cls, state: State) -> "_Search":
        """``state`` at the start of an iteration: no trial taken yet (a
        batch's lanes each at the start of theirs)."""
        zero = torch.zeros(state.nit.shape, dtype=torch.int32, device=state.x.device)
        return cls(*state, k=zero, lr_try=state.lr, w_try=state.w, spent=zero)

    def state(self) -> State:
        return State(*self[: len(State._fields)])


class _NewtonSearch(
    NamedTuple(
        "_NewtonSearchFields",
        [(name, Array) for name in (*_Search._fields, *(f"newton_{f}" for f in Newton._fields))],
    )
):
    """The carry of a solve whose m >= 3 line search runs as carried
    Newton steps, one Newton iteration of the current trial a step: the
    :class:`_Search` fields, then the trial's subproblem carry
    (:class:`~zfista_tpu_torch.core.subproblem.Newton`, each field
    ``newton_``-prefixed; ``newton_nit`` 0 while no subproblem is under
    way, as at an iteration's start)."""

    __slots__ = ()

    @classmethod
    def start(cls, state: State) -> "_NewtonSearch":
        """``state`` at the start of an iteration: no trial taken and no
        subproblem under way (a batch's lanes each at the start of
        theirs)."""
        search = _Search.start(state)
        zero = search.k
        return cls(
            *search, torch.zeros_like(state.w), torch.zeros_like(state.t), zero,
            torch.zeros_like(state.converged), zero, zero,
        )

    def state(self) -> State:
        return State(*self[: len(State._fields)])

    def newton(self) -> Newton:
        return Newton(*self[len(_Search._fields):])


def _newton_trial(newton: NewtonParts, c: _NewtonSearch, data: tuple, live: Array, where):
    """One Newton iteration of the carry's trial, at the subproblem data
    ``(lr_try, F_x, y, f(y), jac_f(y))``: a carry with no subproblem under
    way starts one from its ``w_try``, then every carry iterates once.
    Returns the trial's result as it stands, whether it ended (``live``
    carries only: accepted or rejected this step), and the Newton fields
    after the step: moved where live and not ended, cleared where it ended,
    kept elsewhere.  ``where(mask, u, v)`` selects per carry."""
    before = c.newton()
    fresh = newton.start(*data, c.w_try)
    under_way = before.nit > 0
    nc = newton.iterate(Newton(*(where(under_way, u, v) for u, v in zip(before, fresh))), *data)
    ended = live & newton.ended(nc)
    kept = Newton(
        *(where(ended, torch.zeros_like(u), where(live, u, v)) for u, v in zip(nc, before))
    )
    return newton.finish(nc, *data), ended, kept


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
    feature_sum: Callable[[Array], Array] | None = None,
    feature_max: Callable[[Array], Array] | None = None,
) -> Callable[[State], State]:
    """Build the outer-iteration step, as the JAX ``_make_step`` (all
    options fixed at build time).

    ``feature_sum``/``feature_max`` (a feature-sharded solve; both or
    neither) all-reduce a sum or a NaN-carrying max over features across
    the ranks: the step's iterates are feature blocks, its scalars whole.
    Every host decision of such a step (the accept test, the m >= 3 Newton
    loop's exit, the convergence test, ``adaptive_restart``'s test) reads
    values that are all-reduced or computed from such values, so every rank
    holds them bit for bit and takes them alike; the step is never
    ``capturable`` and has no ``carried_search``.

    ``track_objective=False`` (legal only for single-objective fixed-step
    solves with no history or verbose consumer) skips ``F(x) = f(x) +
    g(x)``: nothing in that iteration reads ``F``, so the carried ``F_x``
    goes stale and the facade recomputes it once at the end.  The
    trajectory is bitwise the same.

    A returned step whose attribute ``masks_itself`` is true leaves a state
    that is not active (:func:`_active` at ``max_iter``) as it is, so a
    chunk loop runs it without :func:`_masked`.  One whose attribute
    ``capturable`` is true reads nothing on the host and carries every
    option it bakes in as ``options``: :func:`run_graphed` captures its
    chunks.  That is the fused LASSO tail, which also takes the step
    tail's ``scratch`` words as a keyword (``takes_scratch``), and the
    generic step at a fixed ``lr`` with at most two objectives, neither
    ``verbose`` nor feature-sharded: its line search returns at once, the
    m = 1 subproblem is one prox and the m = 2 bisection runs a count of
    halvings fixed on the host.

    A backtracking step (``decay_rate < 1``) reads the host once per trial,
    and an m >= 3 step once per Newton iteration of its subproblem.  Not
    ``verbose`` and not feature-sharded, a backtracking step at m <= 2
    (with ``max_backtrack_iter >= 1``) and any m >= 3 step also carry
    ``carried_search``: a capturable step that takes one trial of the line
    search on a :class:`_Search` carry (m <= 2), or one Newton iteration
    of the current trial's subproblem on a :class:`_NewtonSearch` carry
    (m >= 3; a fixed step's one trial is accepted when its Newton loop
    ends), so that a chunk of them reads nothing (the facade runs it where
    ``check_every > 1``).  ``carried_search.start`` makes its carry from a
    :class:`State`.  Its iterations are bitwise those of the step.
    """
    m = n_objectives
    sharded = feature_sum is not None
    fsum = feature_sum if sharded else _identity
    solve_sub = make_subproblem_solver(
        g,
        prox_wsum_g,
        m,
        tol=tol_internal,
        max_iter=max_iter_internal,
        deprecated=deprecated,
        feature_sum=feature_sum,
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
    # the others, and on feature blocks (whose convergence test needs the
    # max over every rank), the fused branch below composes the tail
    # around the kernel's prox and extrapolation.
    fused_tail = fused and not tol_rel and not warm_start and not sharded
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
            if read_flag(ok):  # the one host read per trial
                return _LS(lr, True, x, F_t, w, sub_fun, nits)
            lr = lr * decay_rate
        return _LS(lr, False, x, F_t, w, sub_fun, nits)

    if fused_tail:

        def tail_step(state: State, scratch: Array | None = None) -> State:
            tail = lasso_step_tail(
                state.y, jac_f(state.y)[0], state.x, state.t, state.lr, lam,
                state.err, state.nit, state.nit_internal, state.converged,
                state.failed, a=a, b=b, tol=tol, max_iter=max_iter,
                scratch=scratch,
            )
            return state._replace(**tail._asdict())

        tail_step.masks_itself = True
        # Launches only (the gradient and the tail), no host read, its
        # scalars already 0-d device tensors: a chunk of it can be captured
        # as one CUDA graph (run_graphed), which bakes in these options.
        tail_step.capturable = True
        tail_step.takes_scratch = True
        tail_step.options = (float(a), float(b), float(tol), max_iter)
        return tail_step

    def judge(state: State, x: Array) -> tuple[Array, Array]:
        """``||x - y||_inf`` at the step's ``x`` and the convergence test."""
        err = torch.amax(torch.abs(x - state.y))
        x_max = torch.amax(torch.abs(x)) if tol_rel else None
        if sharded:
            # One all-reduce per step: every rank stops on the same step.
            if tol_rel:
                err, x_max = feature_max(torch.stack([err, x_max]))
            else:
                err = feature_max(err)
        if tol_rel:
            # Opt-in iterate-scaled criterion: ||x - y||_inf < tol +
            # tol_rel * ||x||_inf (0 compiles to the reference test).
            return err, err < tol + tol_rel * x_max
        return err, err < tol

    def momentum(state: State, x: Array) -> tuple[Array, Array]:
        """``t_{k+1}`` and the extrapolated ``y`` from the accepted ``x``."""
        if not nesterov:
            return state.t, x
        t_k = state.t
        if adaptive_restart:
            # O'Donoghue & Candes gradient-scheme restart: reset the
            # momentum when the step opposes the previous direction.
            osc = fsum(dot_hp(state.y - x, x - state.x)) > 0
            t_k = torch.where(osc, torch.ones_like(t_k), t_k)
        t_new = torch.sqrt(t_k**2 - a * t_k + b) + 0.5
        gamma = (t_k - 1) / t_new
        y_new = x + gamma * (x - state.x)
        if project_momentum:
            # Feasible extrapolation: y through the zero-weight prox
            # (for a box-constrained problem, the box projection).
            y_new = prox_wsum_g(
                torch.zeros((m,), dtype=y_new.dtype, device=y_new.device), y_new
            )
        return t_new, y_new

    def accepted(state: State, ls: _LS, err, converged_now, t_new, y_new) -> State:
        """The iteration's end after the line search accepted ``ls``."""
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
            nit=state.nit + 1,
            nit_internal=state.nit_internal + ls.nits,
            converged=converged_now,
            failed=state.failed,
        )

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

        err, converged_now = judge(state, ls.x)
        if not ls.done:
            # Line search exhausted: freeze at the last accepted point; nit
            # does not advance, the inner iterations spent still count.
            nit_internal = state.nit_internal + ls.nits
            if verbose:
                _print_row(state, max_iter, state.nit, nit_internal, err, ls)
            return state._replace(
                nit_internal=nit_internal,
                converged=torch.zeros((), dtype=torch.bool, device=dev),
                failed=torch.ones((), dtype=torch.bool, device=dev),
            )
        if not fused:  # the fused kernel computed t_new and y_new with x
            t_new, y_new = momentum(state, ls.x)
        new = accepted(state, ls, err, converged_now, t_new, y_new)
        if verbose:
            _print_row(state, max_iter, new.nit, new.nit_internal, err, ls)
        return new

    options = (
        float(a), float(b), float(tol), float(tol_rel), m, bool(warm_start),
        bool(nesterov), bool(adaptive_restart), bool(project_momentum),
        bool(deprecated), float(tol_internal), float(tol_internal_rel),
        int(max_iter_internal), bool(track_objective), max_iter,
    )
    if fixed_lr and m <= 2 and not verbose and not sharded:
        # No host read (see the docstring): a chunk of it can be captured,
        # with every option the step bakes in as the graph's key.
        step.capturable = True
        step.options = ("step", *options)

    newton = getattr(solve_sub, "newton", None)  # m >= 3: the Newton parts
    carried = not verbose and not sharded and max_iter is not None and (
        newton is not None or not fixed_lr
    )
    if carried and (fixed_lr or max_backtrack_iter >= 1):
        moved = ("x", "y", "F_x", "lr", "t", "w", "err", "sub_fun", "nit")

        def search_step(c: _Search) -> _Search:
            """One step of the line search (the body of the JAX
            ``line_search`` loop; at m >= 3 one Newton iteration of the
            current trial's subproblem, :func:`_newton_trial`).  Where a
            trial ended, its outcome is selected on the device: accepted,
            the iteration ends as ``step`` ends it; rejected with trials
            left, the State stays and the next trial's ``lr`` decays;
            rejected at ``max_backtrack_iter``, the failure freeze.  A
            fixed step's one trial is accepted when it ends.  An inactive
            carry stays as it is (the step masks itself); it, like a carry
            at an iteration's start, has ``k`` and ``spent`` at 0.  A step
            computes ``f(y)`` and ``jac_f(y)`` again at the same ``y``: the
            same bits."""
            state = c.state()
            live = _active(c, max_iter)
            f_y = f(state.y)
            jac_y = jac_f(state.y)
            if newton is None:
                sub, ended = solve_sub(c.lr_try, state.F_x, state.y, f_y, jac_y, c.w_try), live
                rest = ()
            else:
                data = (c.lr_try, state.F_x, state.y, f_y, jac_y)
                sub, ended, rest = _newton_trial(newton, c, data, live, torch.where)
            f_t = f(sub.x)
            F_t = f_t + g(sub.x)
            ok = ended if fixed_lr else ended & accept_test(state, f_y, f_t, F_t, sub.fun)
            w = sub.weight if warm_start else c.w_try
            spent = c.spent + sub.nit
            ls = _LS(c.lr_try, ok, sub.x, F_t, w, sub.fun, spent)
            err, converged_now = judge(state, sub.x)
            t_new, y_new = momentum(state, sub.x)
            new = accepted(state, ls, err, converged_now, t_new, y_new)
            k = c.k + 1
            out_of_trials = ended & ~ok & (k >= max_backtrack_iter)
            retry = ended & ~(ok | out_of_trials)
            out = _Search(
                **{name: torch.where(ok, getattr(new, name), getattr(c, name)) for name in moved},
                # Accepted or exhausted, the iteration's inner count lands.
                nit_internal=torch.where(ok | out_of_trials, new.nit_internal, c.nit_internal),
                converged=torch.where(ok, new.converged, c.converged),
                failed=c.failed | out_of_trials,
                k=torch.where(retry, k, torch.where(ended, 0, c.k)),
                lr_try=torch.where(retry, c.lr_try * decay_rate, c.lr_try),
                w_try=torch.where(ended, w, c.w_try) if warm_start else c.w_try,
                spent=torch.where(retry, spent, torch.where(ended, 0, c.spent)),
            )
            return out if newton is None else _NewtonSearch(*out, *rest)

        search_step.masks_itself = True
        # No host read: a chunk of steps can be captured.
        search_step.capturable = True
        search_step.options = (
            "search" if newton is None else "newton search",
            *options, float(decay_rate), int(max_backtrack_iter),
        )
        search_step.start = _Search.start if newton is None else _NewtonSearch.start
        step.carried_search = search_step
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
    feature_sum: Callable[[Array], Array] | None = None,
    feature_max: Callable[[Array], Array] | None = None,
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
    tail here.  At a fixed ``lr`` with at most two objectives, not
    feature-sharded, the line search returns at once and the step reads
    nothing: it is marked ``capturable``, with its ``options``, and the
    batch driver replays its chunks as CUDA graphs on a card.

    At m >= 3 the subproblem's Newton loop runs rounds while any lane
    iterates (one host read per round).  Not feature-sharded, a
    backtracking step at m <= 2 (with ``max_backtrack_iter >= 1``) and any
    m >= 3 step also carry ``carried_search``: a capturable step on the
    lane-axis :class:`_Search` carry that takes one trial in every lane
    (m <= 2), or on the :class:`_NewtonSearch` carry one Newton iteration
    of every lane's current trial (m >= 3; the fixed step's one trial is
    accepted when it ends), each lane at its own ``lr`` and its own point
    of its own iteration, the outcome selected per lane where its trial
    ended (accepted, retried at a decayed ``lr``, or failed at
    ``max_backtrack_iter``), so that a chunk of steps reads nothing.  Each
    lane's iterations are bitwise those of the round-based step; a batch
    of them takes as many steps as its slowest lane takes trials (m <= 2)
    or Newton iterations (m >= 3) in all.

    ``feature_sum``/``feature_max`` (lanes that are feature blocks, any
    m; both or neither) all-reduce over the ``"model"`` ranks, as in
    :func:`_make_step`: each lane's ``max|x − y|`` (with ``‖x‖∞`` under
    ``tol_rel``) in one NaN-carrying all-reduce for every lane, and the
    sums over features inside the subproblem (the m = 2 bisection's and
    the m >= 3 Newton dual's, Hessian included) and the restart test, so
    every rank takes each lane's decisions alike: the rounds of trials and
    of Newton iterations read values that every rank holds bit for bit.
    Such a step stays round-based and eager (no ``capturable``, no
    ``carried_search``): Gloo's collectives are not captured into graphs.
    """
    m = n_objectives
    sharded = feature_sum is not None
    fsum = feature_sum if sharded else _identity
    solve_sub = make_batch_subproblem_solver(
        g,
        prox_wsum_g,
        m,
        params,
        tol=tol_internal,
        max_iter=max_iter_internal,
        deprecated=deprecated,
        feature_sum=feature_sum,
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
            if k and not read_flag(torch.any(searching)):  # one host read per round
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

    def accepted(state: State, ls: _LS) -> State:
        """Every lane's iteration end as if its line search accepted
        ``ls``; the caller selects it where it did."""
        err = torch.amax(torch.abs(ls.x - state.y), dim=1)
        x_max = torch.amax(torch.abs(ls.x), dim=1) if tol_rel else None
        if sharded:
            # One all-reduce per step for every lane.
            if tol_rel:
                err, x_max = feature_max(torch.stack([err, x_max]))
            else:
                err = feature_max(err)
        if tol_rel:
            converged_now = err < tol + tol_rel * x_max
        else:
            converged_now = err < tol

        if nesterov:
            t_k = state.t
            if adaptive_restart:
                osc = fsum(v_dot(state.y - ls.x, ls.x - state.x)) > 0
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
        return State(
            x=ls.x,
            y=torch.where(converged_now[:, None], state.y, y_new),
            F_x=ls.F_x,
            lr=ls.lr,
            t=torch.where(converged_now, state.t, t_new),
            w=ls.w,
            err=err,
            sub_fun=ls.sub_fun,
            nit=state.nit + 1,
            nit_internal=state.nit_internal + ls.nits,
            converged=converged_now,
            failed=state.failed,
        )

    def step(state: State) -> State:
        active = _active(state, max_iter)
        f_y = v_f(state.y) if need_f_y else None
        jac_y = v_jac(state.y)
        ls = line_search(state, f_y, jac_y, active)
        new = accepted(state, ls)
        # Per lane: the step where it was active and accepted a trial; where
        # the line search was exhausted, a freeze at the last accepted point
        # (nit does not advance, the inner iterations spent still count,
        # failed); elsewhere the state as it was.
        moved = active & ls.done
        out = State(*(_lanes_where(moved, u, v) for u, v in zip(new, state)))
        return out._replace(
            nit_internal=torch.where(active, new.nit_internal, state.nit_internal),
            failed=state.failed | (active & ~ls.done),
        )

    step.masks_itself = True
    # Every option the steps below bake in, for a graph's key.  A per-lane
    # momentum pair is read by pointer: the caller passes it as an owner.
    pair = ("lanes",) if isinstance(a, torch.Tensor) else (float(a), float(b))
    options = (
        *pair, float(tol), float(tol_rel), m, bool(warm_start),
        bool(nesterov), bool(adaptive_restart), bool(project_momentum),
        bool(deprecated), float(tol_internal), float(tol_internal_rel),
        int(max_iter_internal), bool(track_objective), max_iter,
    )
    if fixed_lr and m <= 2 and not sharded:
        # No host read (its line search returns at once): a chunk of it
        # can be captured.
        step.capturable = True
        step.options = ("batch", *options)

    newton = getattr(solve_sub, "newton", None)  # m >= 3: the Newton parts over lanes
    carried = not sharded and (newton is not None or not fixed_lr)
    if carried and (fixed_lr or max_backtrack_iter >= 1):
        moved = ("x", "y", "F_x", "lr", "t", "w", "err", "sub_fun", "nit")

        def search_step(c: _Search) -> _Search:
            """One step of the line search in every lane (the body of the
            JAX ``line_search`` loop under ``vmap``; at m >= 3 one Newton
            iteration of each lane's current trial), each lane's outcome
            selected on the device where its trial ended, as in
            :func:`_make_step`'s carried search: accepted, the iteration
            ends as ``step`` ends it; rejected with trials left, the State
            stays and the next trial's ``lr`` decays; rejected at
            ``max_backtrack_iter``, the failure freeze.  A lane that is not
            active stays as it is (the step masks itself), with ``k`` and
            ``spent`` at 0.  A step computes ``f(y)`` and ``jac_f(y)``
            again at the same ``y``: the same bits."""
            state = c.state()
            live = _active(state, max_iter)
            f_y = v_f(state.y)
            jac_y = v_jac(state.y)
            if newton is None:
                sub = solve_sub(c.lr_try, state.F_x, state.y, f_y, jac_y, c.w_try, live)
                ended, rest = live, ()
            else:
                data = (c.lr_try, state.F_x, state.y, f_y, jac_y)
                sub, ended, rest = _newton_trial(newton, c, data, live, _lanes_where)
            f_t = v_f(sub.x)
            F_t = f_t + v_g(sub.x)
            ok = ended if fixed_lr else ended & accept_test(state, f_y, f_t, F_t, sub.fun)
            w = sub.weight if warm_start else c.w_try
            spent = c.spent + sub.nit
            new = accepted(state, _LS(c.lr_try, ok, sub.x, F_t, w, sub.fun, spent))
            k = c.k + 1
            out_of_trials = ended & ~ok & (k >= max_backtrack_iter)
            retry = ended & ~(ok | out_of_trials)
            out = _Search(
                **{name: _lanes_where(ok, getattr(new, name), getattr(c, name)) for name in moved},
                # Accepted or exhausted, the iteration's inner count lands.
                nit_internal=torch.where(ok | out_of_trials, new.nit_internal, c.nit_internal),
                converged=torch.where(ok, new.converged, c.converged),
                failed=c.failed | out_of_trials,
                k=torch.where(retry, k, torch.where(ended, 0, c.k)),
                lr_try=torch.where(retry, c.lr_try * decay_rate, c.lr_try),
                w_try=_lanes_where(ended, w, c.w_try) if warm_start else c.w_try,
                spent=torch.where(retry, spent, torch.where(ended, 0, c.spent)),
            )
            return out if newton is None else _NewtonSearch(*out, *rest)

        search_step.masks_itself = True
        # No host read: a chunk of steps can be captured.
        search_step.capturable = True
        search_step.options = (
            "batch search" if newton is None else "batch newton search",
            *options, float(decay_rate), int(max_backtrack_iter),
        )
        search_step.start = _Search.start if newton is None else _NewtonSearch.start
        step.carried_search = search_step
    return step


def _lanes_where(mask: Array, u: Array, v: Array) -> Array:
    """``u`` where a lane's ``mask`` holds, else ``v`` (``mask`` is ``(B,)``,
    ``u`` and ``v`` lane-first of any rank)."""
    return torch.where(mask.view(-1, *(1,) * (u.dim() - 1)), u, v)


def _identity(v: Any) -> Any:
    return v


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


@annotate("zt.drive", call="drive")
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
    while read_flag(active(carry)):  # the one host read per chunk
        for _ in range(check_every):
            carry = body(carry)
    return carry


def make_while_driver(
    step: Callable[[State], State],
    max_iter: int,
    check_every: int = 1,
    owners: tuple[Any, ...] | None = None,
) -> Callable[[State], State]:
    """Run ``step`` until the state is inactive (converged, failed or at
    ``max_iter``), reading the convergence flag on the host once every
    ``check_every`` steps (:func:`run_chunks`; ``owners`` are the
    callables and params the step reads, which key a chunk graph).  Every
    ``check_every`` is bitwise the ``check_every=1`` solve."""

    def run(state: State) -> State:
        return run_chunks(
            step, state, lambda s: _active(s, max_iter), check_every, max_iter, owners
        )

    return run


def run_chunks(
    step: Callable[[Any], Any],
    carry: Any,
    active: Callable[[Any], Array],
    check_every: int,
    max_iter: int,
    owners: tuple[Any, ...] | None = None,
) -> Any:
    """Advance the NamedTuple ``carry`` by ``step`` while ``active`` (which
    is false from step ``max_iter`` on), in chunks of ``check_every``
    steps: each chunk a replayed CUDA graph where :func:`_graphed` says so
    (:func:`run_graphed`), else eager launches (:func:`run_masked`).  Both
    are bitwise the ``check_every=1`` run.  A graph's masked steps replay
    the ``active`` of its capture, so ``step.options`` holds what
    ``active`` bakes in (``max_iter``), and ``owners`` the tensors it
    reads."""
    if _graphed(step, carry, max_iter, check_every, owners):
        return run_graphed(step, carry, active, check_every, owners)
    return run_masked(step, carry, active, check_every)


# -- the chunk as a CUDA graph ----------------------------------------------
#
# The JAX package runs a whole solve as one device program: a while loop
# whose body is a chunk of check_every masked steps.  On a card the port's
# counterpart of "a chunk is one device program" is a CUDA graph of the
# chunk, captured once and replayed once per host read of the active flag.
# The graph reads everything by pointer: the chunk's carry from static
# buffers of the carry's type (copied in before the first replay, cloned
# out after the last read), the operator and the other params from the
# tensors the caller passed, so an in-place change to A is seen, as in the
# eager step.  What the capture baked in (the step's options, check_every,
# the carry's type, shapes and dtypes) keys the cache, with the identity
# of the callables and of the params tensors, held by weak reference: an
# entry whose graph reads a tensor that has died is dropped.


def _graphs_run_on(device: torch.device) -> bool:
    """Whether chunks on ``device`` run as CUDA graphs: on a card.  The CPU
    runs every chunk eagerly."""
    return device.type == "cuda"


def _graphed(step, carry, max_iter: int, check_every: int, owners) -> bool:
    """The graphed driver's rule: a capturable step, ``owners`` given, a
    chunk of more than one step, on a card, and more than one chunk to
    run.  A run whose ``max_iter`` is at most one chunk has nothing to
    replay, so it stays eager, as ``check_every=1`` does."""
    return (
        getattr(step, "capturable", False)
        and owners is not None
        and check_every > 1
        and max_iter > check_every
        and _graphs_run_on(carry[0].device)
    )


def graph_chunk(
    step: Callable[..., Any],
    active: Callable[[Any], Array],
    check_every: int,
    scratch: Array | None = None,
    record: Callable[[Any, Any], tuple] | None = None,
):
    """The chunk that a graph captures, as a plain function of the static
    carry: ``check_every`` steps from ``static`` as a chunk loop runs them
    (:func:`_chunk_body`: masked by ``active`` unless the step masks
    itself), the step tail's ``scratch`` passed to a step that takes it,
    and the last step's fields copied back into ``static`` (the copies
    are nodes of the graph; only the static buffers outlive a replay).
    With ``record`` (a history driver's), step ``j``'s ``record(before,
    after)`` is copied into row ``j`` of the static ``records`` buffers."""
    body = _chunk_body(step, active)
    if scratch is not None:
        body = functools.partial(body, scratch=scratch)

    def chunk(static: Any, records: tuple = ()) -> None:
        carry = static
        for j in range(check_every):
            new = body(carry)
            if record is not None:
                for buf, v in zip(records, record(carry, new)):
                    buf[j].copy_(v)
            carry = new
        for s, c in zip(static, carry):
            if c is not s:
                s.copy_(c)

    return chunk


class CudaChunkGraph:
    """``chunk(static)`` recorded as one CUDA graph on ``stream``, with a
    private memory pool, and kept (``keep_graph``), so that :meth:`nodes`
    can count it; :meth:`instantiate` makes it launchable and
    :meth:`replay` launches it on the current stream.  The graph that is
    instantiated is the one ``capture_end`` would instantiate itself.  A
    capture that fails raises: nothing falls back to eager launches."""

    def __init__(self, chunk: Callable[[Any], None], static: Any, stream) -> None:
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                chunk(static)
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()

    def instantiate(self) -> None:
        self.graph.instantiate()

    def nodes(self) -> int:
        return profiling.cuda_graph_nodes(self.graph)

    def replay(self) -> None:
        self.graph.replay()


#: The graph factory ``(chunk, static, stream) -> object with replay()``,
#: and ``instantiate()`` and ``nodes()`` where it has them: a test on the
#: CPU puts a stand-in here.
CHUNK_GRAPH: Callable[..., Any] = CudaChunkGraph
#: Chunk graphs kept, least recently used out first.
GRAPH_CACHE_SIZE = 8
#: Chunk graphs captured and replays launched since import (or since a
#: caller reset an entry to 0); the steps the captured graphs hold (their
#: ``check_every``, summed); the host ns of the captures' three parts
#: (:meth:`_GraphEntry.capture`), summed; and ``nodes``, the captured CUDA
#: graphs' nodes, summed, once a card has captured one.  The tracing
#: registry's group ``graph``.
graph_counts: dict[str, int] = profiling.register("graph", {
    "captures": 0, "replays": 0, "steps": 0,
    "first_chunk_ns": 0, "record_ns": 0, "instantiate_ns": 0,
})


def _launch_counters() -> tuple[dict[str, int], ...]:
    """The kernel wrappers' launch counters (their names are distinct), as
    the modules hold them now."""
    return fused.launch_counts, tv_cuda.launch_counts


class _GraphEntry:
    """A cached chunk graph and what it owns: the static carry buffers,
    the step tail's scratch words (for a step that takes them), a history
    driver's record buffers (one row a step), the graph (with its private
    memory pool), the kernel launches one replay makes, and weak
    references to the tensors and callables it reads.  Its capture and its
    replays count in :data:`graph_counts`."""

    def __init__(
        self, carry: Any, refs: list, scratch: bool, record=None, check_every: int = 1
    ) -> None:
        dev = carry[0].device
        self.static = type(carry)(
            *(torch.empty_like(v, memory_format=torch.contiguous_format) for v in carry)
        )
        self.scratch = fused.step_tail_scratch(dev) if scratch else None
        self.record = record
        self.records: tuple = ()
        if record is not None:
            self.records = tuple(
                torch.empty((check_every, *v.shape), dtype=v.dtype, device=dev)
                for v in record(carry, carry)
            )
        self.stream = _capture_stream(dev)
        self.refs = refs
        self.graph = None
        self.launches: dict[str, int] = {}

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def capture(self, step, active, check_every: int) -> None:
        """Run one chunk eagerly on the capture stream (the run's first
        chunk; it also warms cuBLAS's workspace for that stream and the
        wrappers' host caches), then record the same chunk as a graph and
        instantiate it, each part a span (``zt.graph.first_chunk``,
        ``zt.graph.record``, ``zt.graph.instantiate``) whose host ns add to
        :data:`graph_counts`.  The launches the capture recorded are what
        each replay adds to the wrappers' ``launch_counts``: the wrappers
        ran once at capture, and those were not launches."""
        chunk = graph_chunk(step, active, check_every, self.scratch, self.record)
        # What the graph reads and writes: the carry's static buffers and
        # the record rows, as one flat tuple.
        n = len(self.static)
        buffers = (*self.static, *self.records)

        def run(b: tuple) -> None:
            chunk(type(self.static)(*b[:n]), b[n:])

        stream = self.stream
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        counters = _launch_counters()
        clock = _time.perf_counter_ns
        with _on_stream(stream):
            t0 = clock()
            with annotate("zt.graph.first_chunk"):
                run(buffers)
            t1 = clock()
            before = [dict(c) for c in counters]
            try:
                with annotate("zt.graph.record"):
                    graph = CHUNK_GRAPH(run, buffers, stream)
                t2 = clock()
                with annotate("zt.graph.instantiate"):
                    getattr(graph, "instantiate", lambda: None)()
                t3 = clock()
                self.graph = graph
                graph_counts["captures"] += 1
                graph_counts["steps"] += int(check_every)
                graph_counts["first_chunk_ns"] += t1 - t0
                graph_counts["record_ns"] += t2 - t1
                graph_counts["instantiate_ns"] += t3 - t2
                nodes = getattr(graph, "nodes", None)
                if nodes is not None:
                    graph_counts["nodes"] = graph_counts.get("nodes", 0) + nodes()
                self.launches = {
                    k: c[k] - b[k] for c, b in zip(counters, before) for k in b
                }
            finally:
                for c, b in zip(counters, before):
                    c.update(b)
        if stream is not None:
            torch.cuda.current_stream(stream.device).wait_stream(stream)

    def replay(self) -> None:
        with annotate("zt.graph.replay"):
            self.graph.replay()
        graph_counts["replays"] += 1
        for counts in _launch_counters():
            for k in counts.keys() & self.launches.keys():
                counts[k] += self.launches[k]


_GRAPHS: OrderedDict[tuple, _GraphEntry] = OrderedDict()
_CAPTURE_STREAMS: dict[torch.device, Any] = {}


def _capture_stream(device: torch.device):
    """The side stream that chunks are captured on, one per card (so cuBLAS
    keeps one workspace for captures); None on the CPU."""
    if device.type != "cuda":
        return None
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _on_stream(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _weak(obj: Any):
    """A weak reference to ``obj`` (to a bound method: to its object and
    function, as a new bound method object is made at every attribute
    access), or, for an object that takes none (a builtin function), a
    strong one: it then lives as long as the entry."""
    try:
        if inspect.ismethod(obj):
            return weakref.WeakMethod(obj)
        return weakref.ref(obj)
    except TypeError:
        return lambda: obj


def _graph_key(step, carry, check_every: int, owners, record=None) -> tuple[tuple, list]:
    """The cache key of a chunk graph, and the references its entry keeps
    to check that what it reads is alive.  Tensors and callables count by
    identity (tensors also by dtype and shape; a bound method by its
    object's and its function's); other params by value, or by identity,
    kept alive, where they do not hash.  A history driver's ``record``
    counts by what it records (its ``tag``)."""
    ids, refs = [], []
    for o in owners:
        if isinstance(o, torch.Tensor):
            ids.append((id(o), o.dtype, tuple(o.shape), o.device))
            refs.append(_weak(o))
        elif inspect.ismethod(o):
            ids.append(("method", id(o.__self__), id(o.__func__)))
            refs.append(_weak(o))
        elif callable(o):
            ids.append(id(o))
            refs.append(_weak(o))
        else:
            try:
                hash(o)
                ids.append(("value", o))
            except TypeError:
                ids.append(("object", id(o)))
                refs.append(lambda o=o: o)
    fields = tuple((v.dtype, tuple(v.shape)) for v in carry)
    key = (step.options, int(check_every), carry[0].device, fields, tuple(ids), type(carry),
           None if record is None else record.tag)
    return key, refs


def _graph_entry(step, carry, check_every: int, owners, record=None) -> _GraphEntry:
    """The cached entry for this run, made (without its graph) on a miss.
    Entries whose tensors or callables died go first; past
    ``GRAPH_CACHE_SIZE`` the least recently used goes."""
    for k in [k for k, e in _GRAPHS.items() if not e.alive()]:
        del _GRAPHS[k]
    key, refs = _graph_key(step, carry, check_every, owners, record)
    entry = _GRAPHS.get(key)
    if entry is None:
        scratch = getattr(step, "takes_scratch", False)
        entry = _GRAPHS[key] = _GraphEntry(carry, refs, scratch, record, check_every)
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    return entry


@annotate("zt.drive", call="drive")
def run_graphed(
    step: Callable[..., Any],
    carry: Any,
    active: Callable[[Any], Array],
    check_every: int,
    owners: tuple[Any, ...],
    record: Callable[[Any, Any], tuple] | None = None,
    after_chunk: Callable[[tuple], None] | None = None,
) -> Any:
    """:func:`run_masked` for a capturable step, each chunk one replay of a
    cached CUDA graph (:func:`graph_chunk` captured by ``CHUNK_GRAPH``):
    the carry is copied into the entry's static buffers, the host reads
    ``active`` once per chunk, as the eager loop does, and the result is a
    copy taken after the last read.  On a cache miss the first chunk runs
    eagerly and is then captured.  Bitwise the ``check_every=1`` run,
    step count included: frozen steps in the last chunk run and are
    discarded by the mask.  With ``record`` (:func:`run_recorded`) each
    chunk also fills the entry's record rows, which ``after_chunk`` is
    given after each chunk."""
    entry = _graph_entry(step, carry, check_every, owners, record)
    static = entry.static
    for s, v in zip(static, carry):
        s.copy_(v)
    while read_flag(active(static)):  # the one host read per chunk
        if entry.graph is None:
            entry.capture(step, active, check_every)
        else:
            entry.replay()
        if after_chunk is not None:
            after_chunk(entry.records)
    return type(carry)(*(s.clone() for s in static))


@annotate("zt.drive", call="drive")
def run_recorded(
    step: Callable[..., Any],
    carry: Any,
    active: Callable[[Any], Array],
    steps: int,
    owners: tuple[Any, ...],
    record: Callable[[Any, Any], tuple],
    chunk: int,
    sink: Callable[[tuple], None],
) -> Any:
    """The history drivers' graphed loop: :func:`run_graphed` of a
    capturable step at ``steps`` steps a replay, each step's
    ``record(before, after)`` (:func:`history_record`) written into the
    entry's record rows.  The host reads ``active`` once per replay; after
    each replay a few device copies move its rows out, and once per
    ``chunk`` steps (or the first replay past them) the rows go to
    ``sink`` as host numpy arrays, steps first.  The carry is as
    :func:`run_graphed` leaves it: steps after the last active one are
    masked, and record nothing (``done`` and ``ended`` false)."""
    pending: list[tuple] = []

    def flush() -> None:
        if pending:
            sink(tuple(device_to_host(torch.cat(v)).numpy() for v in zip(*pending)))
            pending.clear()

    def take(rows: tuple) -> None:
        pending.append(tuple(r.clone() for r in rows))
        if len(pending) * steps >= chunk:
            flush()

    carry = run_graphed(step, carry, active, steps, owners, record, take)
    flush()
    return carry


def history_record(vecs: bool) -> Callable[[Any, Any], tuple]:
    """What a history driver records of one step, from the carry before it
    and after it (a :class:`State` or a :class:`_Search`, with or without
    the lane axis): ``ended`` (the step ended an iteration: accepted, or
    failed its line search), ``done`` (accepted: ``nit`` advanced), the
    ``nit`` before it (the iteration's row), and ``F_x``, ``err`` and, with
    ``vecs``, ``x`` after it.  A per-step driver's row is "active before
    and not failed after", which is ``done`` for any step that ran."""

    def record(before: Any, after: Any) -> tuple:
        done = after.nit != before.nit
        ended = done | (after.failed & ~before.failed)
        out = (ended, done, before.nit, after.F_x, after.err)
        return out + (after.x,) if vecs else out

    record.tag = ("history", bool(vecs))
    return record


#: Steps per replayed graph of a history driver, by objective count
#: (:func:`_history_steps`).
HISTORY_GRAPH_STEPS: dict[int, int] = {1: 4, 2: 2, 3: 2, 4: 1}


def _history_steps(step, carry, max_iter: int, owners, n_objectives: int) -> int:
    """The history drivers' rule: the steps a replay of ``step``'s graph
    runs (``HISTORY_GRAPH_STEPS``), or 0 for the per-step driver.  A graph
    needs a capturable step (at m >= 3 the carried Newton steps), an entry
    for the objective count, ``owners``, a card (:func:`_graphs_run_on`)
    and a ``max_iter`` past one replay; ``verbose`` and feature-sharded
    steps are not capturable, and the CPU steps one at a time.

    A first solve graphs too, and few steps a graph keep its capture
    short (10-90 µs of host time a node, ~600 nodes an m = 2 step, ~680
    an m >= 3 Newton step).  First solves on an H100 80GB HBM3 at 700 W,
    each from an empty graph cache, in two turns (``python -m
    zfista_tpu_torch.bench.history_bench``):

    * m >= 3, the harness's 22 m >= 3 cells (``benchmark()``, 100 float64
      starts, every variant), summed, s at 1 / 2 / 4 / 8 steps a graph:
      m = 3 (FDS and TRIDIA, 16 cells) 52.3-53.2 / 51.7-51.9 / 53.7-54.3
      / 54.9-55.2, the per-step driver 788.4 (one turn); m = 4
      (LinearFunctionRank1, 6 cells) 1.72-2.12 / 2.02-2.12 / 2.51-2.62 /
      3.69-3.85, per-step 24.6.  1 was fastest on 20 of the m = 3 cells'
      32 runs (the short ones: a smaller capture) and 9 of m = 4's 12,
      2 on the sum at m = 3 (no count past 4 was timed: m >= 5 steps
      one at a time);
    * m = 2, the harness's 26 m <= 2 cells (``benchmark()``, 100 float64
      starts, every variant) summed 7.49-7.60 s at 2 steps a graph and
      10.00-10.08 s at 4; 2 was faster in both turns on 25 of the 26;
    * m = 1, steps 2 / 4 / 8 / 16 / 32 against the per-step driver, s:
      the LASSO (2000 x 10,000 float32, 293 iterations) by
      ``solve_fixed_step(return_all=True)`` 0.10-0.14 / 0.097-0.100 /
      0.096-0.098 / 0.11-0.13 / 0.16-0.25 against 0.31-0.40; by the
      backtracking ``solve(return_all=True)`` (270) 0.097-0.107 /
      0.100-0.107 / 0.109-0.112 / 0.13-0.14 / 0.16-0.18 against
      0.30-0.34; the 1k-lambda sweep with history (320 steps)
      0.31-0.34 / 0.32 / 0.34-0.37 / 0.40-0.43 / 0.51-0.71 against
      1.40-1.65; 4 is within 5% of the fastest on each, 16 and 32 pay
      for their longer capture.

    The harness CLI at ``--max-iter 3`` (one or two replays a capture)
    took 51.5-52.3 s graphed against 48.0-48.8 s per step, on one CPU
    thread."""
    steps = HISTORY_GRAPH_STEPS.get(n_objectives, 0)
    graphed = (
        steps >= 1
        and getattr(step, "capturable", False)
        and owners is not None
        and max_iter > steps
        and _graphs_run_on(carry[0].device)
    )
    return steps if graphed else 0


@annotate("zt.drive", call="drive")
def _run_history(step, state: State, max_iter: int, chunk: int):
    """The per-step history driver: step while active, recording ``(x,
    F_x, err)`` of every step that ran and did not fail the line search.

    The JAX scan driver runs whole chunks of masked steps; here the host
    reads ``active`` before every step instead, so a frozen state is never
    stepped (each frozen backtracking step would re-run its line search).
    The steps recorded, and the final state, are the same.  Records are
    copied to the host once per ``chunk`` steps, as numpy rows.  A
    capturable step on a card takes :func:`_run_history_graphed` instead.
    """
    xs, fs, errs, pending = [], [], [], []

    def flush():
        if pending:
            x, F, e, rec = (device_to_host(torch.stack(v)).numpy() for v in zip(*pending))
            xs.extend(x[rec])
            fs.extend(F[rec])
            errs.extend(e[rec])
            pending.clear()

    while read_flag(_active(state, max_iter)):
        state = step(state)
        pending.append((state.x, state.F_x, state.err, ~state.failed))
        if len(pending) >= chunk:
            flush()
    flush()
    return state, xs, fs, errs


def _run_history_graphed(step, carry, max_iter: int, steps: int, owners, chunk: int):
    """:func:`_run_history` for a capturable step (the fixed step or the
    carried search at m <= 2) on :func:`run_recorded`: ``steps`` steps a
    replay, one host read per replay.  A row is kept where the step
    accepted an iteration (a carried search's trial that ended one), so
    the history is the per-step driver's, bitwise."""
    xs, fs, errs = [], [], []

    def sink(rows: tuple) -> None:
        _, done, _, F, e, x = rows
        xs.extend(x[done])
        fs.extend(F[done])
        errs.extend(e[done])

    active = lambda c: _active(c, max_iter)  # noqa: E731
    carry = run_recorded(step, carry, active, steps, owners, history_record(True), chunk, sink)
    return carry, xs, fs, errs


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


def _feature_placement(x0: Any):
    """The feature sharding ``x0`` is a block of (None: ``x0`` is whole)."""
    if not isinstance(x0, torch.Tensor):
        return None
    # Imported here: the parallel package imports this module.
    from zfista_tpu_torch.parallel.sharding import sharding_of

    sh = sharding_of(x0)
    if sh is not None and (sh.dim != "model" or x0.dim() != 1):
        raise ValueError(
            f"a single solve starts from a whole x0 or a block laid out by "
            f"feature_sharding (P('model')); got {sh.spec!r}, shape {tuple(x0.shape)}"
        )
    return sh


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
    there.  An ``x0`` tagged as a block of a feature-sharded iterate
    (``parallel.sharding.feature_sharding``) makes a feature-sharded
    solve at any objective count (see the module note; the callables
    reduce over the ranks themselves); ``initial_state`` then holds whole
    iterates, as the result does.

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

    ``check_every=None`` picks 64 on a CUDA device (one host read of the
    convergence flag per 64 steps) for a single-objective fixed-step solve
    when nothing reads every iteration (not ``return_all``, ``verbose`` or
    ``iter_chunk``), and 1 elsewhere, backtracking solves included
    (:func:`_default_check_every`).  At ``check_every > 1`` (not
    ``verbose``, ``return_all``, ``iter_chunk`` or feature-sharded) a
    backtracking solve with at most two objectives runs one trial of its
    line search per step, and a solve with three or more (fixed step
    included) one Newton iteration of its current trial's subproblem per
    step, its search carried on the device: ``check_every`` then counts
    those steps, and no host read happens inside a chunk.  Otherwise the
    line search is a host loop, each trial's accept test a host read, and
    an m >= 3 subproblem reads once per Newton iteration.  On a card the
    chunks of a fixed-step solve with at most two objectives (not
    ``verbose``, not feature-sharded) and of those carried steps run as
    replayed CUDA graphs (:func:`run_graphed`), and so does ``return_all``
    for such a solve (its line search as carried steps, a row kept where
    a step ends its iteration), a few steps a replay
    (:func:`_history_steps`).  ``iter_chunk`` runs at most that many steps between
    host copies of the state; when the device faults inside a chunk, the
    solve returns the last chunk's host copy with ``success=False``,
    status 2 and a "device fault" message, without touching the device
    again.  Every ``check_every``/``iter_chunk`` gives bitwise the result
    of ``check_every=1``.

    Returns a :class:`SolveResult` with fields
    ``x, fun, success, status, message, nit, nit_internal, time, weight``
    as numpy values, and ``state``, the final :class:`State` as numpy.
    """
    with annotate("zt.solve", call="entry"):
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
        with annotate("zt.setup"):
            dev = _solve_device(x0, params, device)
            fsh = _feature_placement(x0)
            x0 = torch.as_tensor(x0, device=dev)
            if not x0.is_floating_point():
                x0 = x0.to(torch.get_default_dtype())
            feature_sum = feature_max = None
            to_host = state_to_numpy
            if fsh is not None:
                from zfista_tpu_torch.parallel import sharding as shd

                group = fsh.group
                feature_sum = lambda v: shd.all_reduce_sum(v, group)
                feature_max = lambda v: shd.all_reduce_max(v, group)

                def to_host(s: State) -> State:
                    # The whole iterates on every rank (JAX: _device_get_global).
                    whole = s._replace(x=shd.gather(s.x, fsh), y=shd.gather(s.y, fsh))
                    return state_to_numpy(whole)

                x0_res = device_to_host(shd.gather(x0, fsh)).numpy()
            else:
                # The host copy of x0 for the result, taken before the device
                # does any work (a faulted solve must not read the device again).
                x0_res = device_to_host(x0).numpy().copy()
            if params is not None:
                f_b, g_b, jac_b, prox_b = _bind_params(f, g, jac_f, prox_wsum_g, params)
            else:
                f_b, g_b, jac_b, prox_b = f, g, jac_f, prox_wsum_g
            f_v, g_v, jac_v, prox_v, m, scalar_mode = _normalize_problem(
                f_b, g_b, jac_b, prox_b, x0
            )

            if check_every is None:
                per_iteration = return_all or verbose or iter_chunk is not None
                check_every = _default_check_every(
                    dev.type, m, decay_rate, per_iteration=per_iteration
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
                feature_sum=feature_sum,
                feature_max=feature_max,
            )

            if verbose:
                hdr = ["niter", "nit int", "max|xk - yk|", "subprob func", "lr"]
                widths = [6, 8, 13, 13, 10]
                print("|" + "|".join(h.center(w) for h, w in zip(hdr, widths)) + "|")
                print("|" + "|".join("-" * w for w in widths) + "|")

            if initial_state is not None:
                state = State(*(_to_device(v, dev) for v in initial_state))
                if fsh is not None:
                    state = state._replace(x=shd.block(state.x, fsh), y=shd.block(state.y, fsh))
            else:
                lr_t = torch.as_tensor(lr, dtype=x0.dtype, device=dev)
                state = init_state(x0, f_v(x0) + g_v(x0), m, lr_t)

            device_faulted = False
            allvecs = allfuns = allerrs = None
            # What the step reads by pointer: a chunk graph's cache key.
            leaves = params if isinstance(params, (tuple, list)) else (params,)
            owners = (f, g, jac_f, prox_wsum_g, *leaves)
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
            head_x = x0_res if initial_state is None else to_host(state).x
            head_F = device_to_host(state.F_x).numpy()
            # On a card: the fixed step at m <= 2, or the line search as
            # carried steps (a row where a step ends its iteration), on
            # replayed graphs.
            search = getattr(step, "carried_search", None)
            graph_step = step if search is None else search
            steps = _history_steps(graph_step, state, max_iter, owners, m)
            if steps:
                carry = state if search is None else search.start(state)
                carry, xs, fs, allerrs = _run_history_graphed(
                    graph_step, carry, max_iter, steps, owners, chunk
                )
                state = carry if search is None else carry.state()
            else:
                state, xs, fs, allerrs = _run_history(step, state, max_iter, chunk)
            if fsh is not None and xs:
                xs = list(shd.gather_numpy(np.stack(xs), fsh, dev, axis=1))
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
            with annotate("zt.drive", call="drive"):
                host = to_host(state)
                while bool(_active(host, max_iter)):
                    try:
                        for _ in range(iter_chunk):
                            state = masked(state)
                        host = to_host(state)
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
            search = getattr(step, "carried_search", None)
            if search is not None and check_every > 1:
                # The line search as carried steps: check_every counts them.
                run = make_while_driver(search, max_iter, check_every, owners)
                state = run(search.start(state)).state()
            else:
                state = make_while_driver(step, max_iter, check_every, owners)(state)

        with annotate("zt.pack"):
            if not device_faulted:
                if skip_F:
                    # The step skips F (see _make_step): recompute it once at the end.
                    state = state._replace(F_x=f_v(state.x) + g_v(state.x))
                host = to_host(state)
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


def _default_check_every(
    device_type: str, n_objectives: int, decay_rate: float, *, per_iteration: bool
) -> int:
    """``check_every=None``'s pick: 64 on a CUDA device (one host read of
    the convergence flag per 64 steps) for a single-objective fixed-step
    solve that nothing reads every iteration (``per_iteration``:
    ``return_all``, ``verbose``, ``iter_chunk``); 1 elsewhere.  The JAX
    rule with "device is CUDA" for "backend is TPU": chunking keeps a card
    fed between host reads; on the CPU the step itself is the host's work
    and per-step checking stops earliest.

    A backtracking solve stays at 1, though at ``check_every > 1`` its
    carried trials run as replayed graphs: on an H100 (700 W) a first
    backtracking LASSO solve (2000 x 10,000 float32, 275 trials) at 64,
    with its eager chunk and its capture, took 0.235 s on average against
    0.224 s at 1 (six of each, in turns); a repeat solve on the cached
    graph runs an iteration in about half the time of ``check_every=1``."""
    if device_type == "cuda" and n_objectives == 1 and decay_rate == 1 and not per_iteration:
        return 64
    return 1


def state_to_numpy(state: State) -> State:
    """``state`` with every field copied to the host as a numpy array (a
    counted read a field)."""
    return State(*(device_to_host(v).numpy() for v in state))
