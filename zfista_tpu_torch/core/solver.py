r"""ISTA/FISTA with the generalized momentum factor, in eager PyTorch.

PyTorch-port counterpart of :mod:`zfista_tpu.core.solver`: the outer
iteration — subproblem, convergence check on
:math:`\|x^k - y^k\|_\infty`, and the generalized momentum rule

.. math::

    t_{k+1} = \sqrt{t_k^2 - a\,t_k + b} + \tfrac12,\qquad
    y^{k+1} = x^k + \frac{t_k - 1}{t_{k+1}} (x^k - x^{k-1}).

This slice ports the scalar fixed-step half: one objective (``m == 1``),
``decay_rate == 1`` (the single closed-form prox step, accepted
unconditionally), no history.  Every option outside it raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.

Where the JAX package compiles the whole solve into one ``lax.while_loop``,
the port runs the same step eagerly: a :class:`State` of device tensors
advanced by a Python function.  The device is never read inside a chunk of
``check_every`` steps; the host reads the convergence flag once per chunk.
Every step a run takes is computed from the same inputs in the same order,
so any ``check_every`` gives a result bitwise equal to ``check_every=1``.

On dense LASSO (:meth:`zfista_tpu_torch.models.Lasso.solve_fixed_step`)
the step runs the soft-threshold prox and the momentum extrapolation as
one launch of the fused CUDA kernel
(:func:`zfista_tpu_torch.ops.fused.fused_prox_momentum`).
"""

from __future__ import annotations

import time as _time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.result import TERMINATION_MESSAGES, SolveResult
from zfista_tpu_torch.core.subproblem import make_subproblem_solver
from zfista_tpu_torch.ops.fused import fused_prox_momentum

# Private seam between the LASSO params callables and the step.  A
# params-style prox ``prox(w, x, p)`` carrying ``_SOFT_THRESHOLD_LAM_OF``
# computes ``soft_threshold(x, w * lam_of(p))``; once bound to its params
# (and normalized) it carries ``_SOFT_THRESHOLD_LAM = lam``.  The fixed-lr
# nesterov step then computes the prox and the extrapolation with one
# fused kernel launch instead of composing them.
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
    max_iter_internal: int,
    warm_start: bool,
    nesterov: bool,
    nesterov_ratio: tuple[float, float],
    deprecated: bool,
) -> Callable[[State], State]:
    """Build the fixed-lr (``decay_rate == 1``) outer-iteration step.

    This is the JAX step with ``track_objective=False``: nothing in the
    scalar fixed-lr iteration reads ``F``, so the step never evaluates
    ``f`` or ``g``.  The carried ``F_x`` goes stale and the facade
    recomputes it once at the end.  The single subproblem solve is always
    accepted, so the JAX step's failure select is the identity and is
    left out; ``failed`` stays False.
    """
    solve_sub = make_subproblem_solver(
        g,
        prox_wsum_g,
        n_objectives,
        tol=tol_internal,
        max_iter=max_iter_internal,
        deprecated=deprecated,
    )
    a, b = nesterov_ratio
    lam = getattr(prox_wsum_g, _SOFT_THRESHOLD_LAM, None)
    fused = nesterov and lam is not None

    def step(state: State) -> State:
        grad = jac_f(state.y)[0]
        if nesterov:
            t_k = state.t
            t_new = torch.sqrt(t_k**2 - a * t_k + b) + 0.5
            gamma = (t_k - 1) / t_new
        if fused:
            # x = soft(y - lr*grad, lr*lam): the closed-form subproblem at
            # the prox weight lr, with the extrapolation in the same pass.
            x, y_new = fused_prox_momentum(
                state.y, grad, state.x, state.lr, state.lr * lam, gamma
            )
            w = torch.ones_like(state.w) if warm_start else state.w
        else:
            sub = solve_sub(
                state.lr, state.F_x, state.y, None, grad[None], state.w
            )
            x = sub.x
            w = sub.weight if warm_start else state.w
            if nesterov:
                y_new = x + gamma * (x - state.x)
            else:
                t_new = state.t
                y_new = x

        err = torch.amax(torch.abs(x - state.y))
        if tol_rel:
            converged_now = err < tol + tol_rel * torch.amax(torch.abs(x))
        else:
            converged_now = err < tol
        # Converged step: keep the old y/t (the JAX step's freeze).  The
        # kernel wrote y_new into a fresh tensor, so state.y is intact.
        return State(
            x=x,
            y=torch.where(converged_now, state.y, y_new),
            F_x=state.F_x,
            lr=state.lr,
            t=torch.where(converged_now, state.t, t_new),
            w=w,
            err=err,
            sub_fun=state.sub_fun,
            nit=state.nit + 1,
            nit_internal=state.nit_internal + 1,
            converged=converged_now,
            failed=state.failed,
        )

    return step


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


def run_masked(
    step: Callable[[Any], Any],
    carry: Any,
    active: Callable[[Any], Array],
    check_every: int,
) -> Any:
    """Advance the NamedTuple ``carry`` by ``step`` while ``active``,
    reading the device's flag on the host once every ``check_every``
    steps.

    Inside a chunk each step is masked (one ``torch.where`` per field): a
    carry that stopped mid-chunk stays frozen, so the result is BITWISE
    IDENTICAL to ``check_every=1``, step count included.  The mask
    SELECTS, never multiplies: a frozen step still runs (a prox call, for
    instance), and whatever it computes, NaN included, never reaches the
    carry.  The chunk enqueues its steps without waiting for the device,
    which is what the chunking buys on a CUDA card.
    """

    def masked_step(c: Any) -> Any:
        a = active(c)
        new = step(c)
        return type(c)(*(torch.where(a, n, o) for n, o in zip(new, c)))

    # A chunk is entered only from an active carry, where the mask is the
    # identity: with one step per chunk it is left out.
    body = step if check_every == 1 else masked_step
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
) -> tuple[Any, Any, Any, Any, int, bool]:
    """Normalize user callables to vector form: f,g -> (m,), jac -> (m,n),
    prox(w_vec, x). Returns (f, g, jac, prox, m, scalar_mode).

    One eager call of ``f`` at ``x0`` gives the output shape (the JAX
    version traces ``jax.eval_shape``)."""
    out = f(x0)
    scalar_mode = out.dim() == 0
    if scalar_mode:
        m = 1
        f_v = lambda x: torch.reshape(f(x), (1,))
        g_v = lambda x: torch.reshape(g(x), (1,))
        if jac_f is None:
            grad = torch.func.grad(lambda z: torch.sum(f(z)))
            jac_v = lambda x: torch.reshape(grad(x), (1, -1))
        else:
            jac_v = lambda x: torch.reshape(jac_f(x), (1, -1))
        prox_v = lambda w, x: prox_wsum_g(w[0], x)
    else:
        m = out.shape[0]
        f_v = f
        g_v = g
        if jac_f is None:
            jac_v = torch.func.jacfwd(f)
        else:
            jac_v = lambda x: torch.reshape(jac_f(x), (m, -1))
        if m == 1:
            # Reference convention: scalar weight when there is one objective.
            prox_v = lambda w, x: prox_wsum_g(w[0], x)
        else:
            prox_v = prox_wsum_g
    prox_v = _copy_soft_threshold_mark(prox_wsum_g, prox_v)
    return f_v, g_v, jac_v, prox_v, m, scalar_mode


def _solve_device(x0: Any, params: Any) -> torch.device:
    """The solve's device, from the tensors passed in: ``x0``'s if it is a
    tensor, else that of the first tensor in ``params``, else the CPU."""
    if isinstance(x0, torch.Tensor):
        return x0.device
    for leaf in params if isinstance(params, (tuple, list)) else (params,):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


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
) -> SolveResult:
    r"""Minimize :math:`F(x) = f(x) + g(x)` with one objective, fixed step.

    The JAX package's facade, with its signature and defaults, over eager
    PyTorch.  ``f``, ``g``, ``jac_f`` and ``prox_wsum_g`` take and return
    tensors; ``jac_f=None`` derives the gradient with ``torch.func``.
    ``params`` (optional tuple) is passed as every callable's trailing
    argument.  The solve runs on ``x0``'s device when ``x0`` is a tensor,
    else on that of the first tensor in ``params``, else on the CPU.

    Ported: ``decay_rate=1`` (fixed step ``lr``), one objective, ISTA or
    FISTA (``nesterov``) with any ``nesterov_ratio``, ``tol``/``tol_rel``,
    ``check_every``.  ``None`` picks 64 for a solve on a CUDA device (one
    host read of the convergence flag per 64 steps) and 1 elsewhere; every
    value gives bitwise the same result.  Backtracking (``decay_rate !=
    1``), several objectives, ``return_all``, ``verbose``, ``iter_chunk``,
    ``initial_state``, ``adaptive_restart``, ``project_momentum`` and
    ``tol_internal_rel`` raise ``NotImplementedError``.

    Returns a :class:`SolveResult` with fields
    ``x, fun, success, status, message, nit, nit_internal, time, weight``
    as numpy values, and ``state``, the final :class:`State` as numpy.
    """
    unported = {
        "decay_rate != 1 (backtracking line search)": decay_rate != 1,
        "return_all (history driver)": return_all,
        "verbose (iteration trace)": verbose,
        "iter_chunk (host-chunked driver)": iter_chunk is not None,
        "initial_state (resume)": initial_state is not None,
        "adaptive_restart": adaptive_restart,
        "project_momentum": project_momentum,
        "tol_internal_rel (line-search accept slack)": tol_internal_rel != 0,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to zfista_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 4)"
            )
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
    start = _time.perf_counter()

    dev = _solve_device(x0, params)
    x0 = torch.as_tensor(x0, device=dev)
    if not x0.is_floating_point():
        x0 = x0.to(torch.get_default_dtype())
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
    max_iter = int(max_iter)
    step = _make_step(
        f_v,
        g_v,
        jac_v,
        prox_v,
        m,
        tol=tol,
        tol_rel=float(tol_rel),
        tol_internal=tol_internal,
        max_iter_internal=int(max_iter_internal),
        warm_start=warm_start,
        nesterov=nesterov,
        nesterov_ratio=tuple(nesterov_ratio),
        deprecated=deprecated,
    )
    lr_t = torch.as_tensor(lr, dtype=x0.dtype, device=dev)
    state = init_state(x0, f_v(x0) + g_v(x0), m, lr_t)
    state = make_while_driver(step, max_iter, check_every)(state)
    # The step skips F (see _make_step): recompute it once at the end.
    state = state._replace(F_x=f_v(state.x) + g_v(state.x))

    host = state_to_numpy(state)
    x0_res = x0.detach().cpu().numpy().copy()
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
        allvecs=None,
        allfuns=None,
        allerrs=None,
        state=host,
    )
    if bool(host.failed):
        res.success = False
        res.status = 2
        res.message = TERMINATION_MESSAGES[2]
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
