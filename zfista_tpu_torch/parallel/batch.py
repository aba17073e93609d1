r"""Many independent solves as one lane-batched solve, in eager PyTorch.

PyTorch-port counterpart of :mod:`zfista_tpu.parallel.batch`: the same
public surface (``minimize_proximal_gradient_batch``, ``BatchResult``) and
the same per-lane semantics.  Each lane carries its own solver
:class:`~zfista_tpu_torch.core.solver.State` (learning rate, momentum, dual
weights, convergence flags); every field has a leading lane axis, and one
lane-masked step (:func:`zfista_tpu_torch.core.solver._make_batch_step`)
advances all lanes together.  The problem callables run over the lanes by
``torch.func.vmap``, so one launch serves every lane.

Where the JAX package vmaps its single step and lets XLA turn each lane's
``while_loop`` into one masked loop, the port's step holds host decisions
(line-search trials, the m>=3 Newton loop).  In the batch they are masks:
a loop runs while any lane still needs it, with one host read per round
for all lanes, and a lane that is done keeps its values.  A lane that is
not active (converged, failed or at ``max_iter``) keeps its state, so the
drivers need no mask of their own:

* ``check_every`` / ``iter_chunk``: that many steps between host reads of
  "is any lane still active", bitwise equal to ``check_every=1``;
* history (``history=True``): one read of the same flag per step; the
  per-step records (``F``, the error, the iterate with ``record_vecs``)
  stay on the device and are copied to the host once per
  ``history_chunk`` steps.

Per-lane problem data (a λ sweep, per-lane operators) enters through
``batch_params``, passed as the callables' last argument, and per-lane
momentum pairs through ``batch_nesterov_ratio``.  ``lane_chunk`` solves
the batch in chunks of lanes and concatenates the results.

Not ported: the TPU backend's width and depth auto-guards and the
compiled-driver cache (eager PyTorch compiles nothing); ``in_sharding``
belongs to the scale-out slice.
"""

from __future__ import annotations

import time as _time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from zfista_tpu_torch.core.result import TERMINATION_MESSAGES, SolveResult
from zfista_tpu_torch.core.solver import (
    State,
    _active,
    _make_batch_step,
    _normalize_problem,
    _over_lanes,
    _solve_device,
    _to_device,
    run_masked,
    state_to_numpy,
)

#: Result fields carrying a leading lane axis — the lane_chunk merge's
#: classification registry (see _lane_chunked_solve): an ndarray field of
#: chunk-width length must appear here to be concatenated across chunks.
_PER_LANE_RESULT_KEYS = frozenset(
    {
        "x0",
        "x",
        "fun",
        "weight",
        "nit",
        "nit_internal",
        "lr",
        "error_criterion",
        "success",
        "status",
        "nesterov_ratio",  # (B, 2) when the batch ran per-lane pairs
        "allfuns",
        "allerrs",
        "history_mask",
        "allvecs",
        "F0",
        "vec_head",
    }
)


class BatchResult(SolveResult):
    """A :class:`SolveResult` whose array fields carry a leading batch axis.

    ``to_list()`` explodes it into per-lane :class:`SolveResult` objects with
    the single solve's semantics.
    """

    def to_list(self) -> list[SolveResult]:
        n = len(self.x)
        out = []
        for i in range(n):
            r = SolveResult(
                x0=self.x0[i],
                x=self.x[i],
                fun=self.fun[i],
                weight=self.weight[i],
                nit=int(self.nit[i]),
                nit_internal=int(self.nit_internal[i]),
                lr=float(self.lr[i]),
                error_criterion=float(self.error_criterion[i]),
                success=bool(self.success[i]),
                status=int(self.status[i]),
                message=TERMINATION_MESSAGES.get(int(self.status[i]), self.message),
                time=self.time / n,  # amortized wall time per lane
                tol=self.tol,
                tol_rel=self.get("tol_rel", 0.0),
                tol_internal=self.tol_internal,
                tol_internal_rel=self.get("tol_internal_rel", 0.0),
                nesterov=self.nesterov,
                # (B, 2) when the batch ran per-lane momentum pairs
                nesterov_ratio=(
                    tuple(float(v) for v in self.nesterov_ratio[i])
                    if getattr(self.nesterov_ratio, "ndim", 0) == 2
                    else self.nesterov_ratio
                ),
            )
            if self.get("allfuns") is not None:
                mask = self.history_mask[i]
                funs = np.asarray(self.allfuns[i])[mask]
                scalar = np.ndim(self.fun[i]) == 0
                # F(x0) first, as the single solve's return_all history.
                if self.get("F0") is not None:
                    F0_i = np.asarray(self.F0[i])
                    r.allfuns = [float(F0_i[0]) if scalar else F0_i]
                else:
                    r.allfuns = []
                r.allfuns += [float(v[0]) if scalar else v for v in funs]
                r.allerrs = list(np.asarray(self.allerrs[i])[mask])
                if self.get("allvecs") is not None:
                    # The iterate the run started from: x0, or the resume
                    # iterate of an initial_states run (paired with F0).
                    head = (
                        np.asarray(self.vec_head[i])
                        if self.get("vec_head") is not None
                        else np.asarray(self.x0[i])
                    )
                    r.allvecs = [head] + list(np.asarray(self.allvecs[i])[mask])
            out.append(r)
        return out


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of nested tuples, lists and dicts (NamedTuples
    keep their type)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _lane_chunked_solve(
    f,
    g,
    jac_f,
    prox_wsum_g,
    x0s,
    *,
    batch_params,
    batch_nesterov_ratio,
    initial_states,
    lane_chunk,
    keep_state,
    start,
    solver_kwargs,
) -> BatchResult:
    """Run :func:`minimize_proximal_gradient_batch` in chunks of
    ``lane_chunk`` lanes and concatenate the per-lane results.

    Every chunk is PADDED to exactly ``lane_chunk`` lanes (repeating its
    first lane), so all chunks have one width; padded lanes are trimmed
    before concatenation, so the merged result is lane for lane what the
    unchunked call returns.

    A device fault (``torch.AcceleratorError``) in a chunk after the first
    keeps the chunks already solved and marks the rest status 2 (x = x0,
    ``fun`` NaN, ``nit`` 0) with no further dispatch, a warning and a
    message naming the lane where the fault hit; a fault in the first chunk
    propagates.
    """
    B = int(x0s.shape[0])
    K = int(lane_chunk)

    def _cut(tree, s, e):
        pad = K - (e - s)

        def one(a):
            seg = a[s:e]
            if pad:
                rep = seg[:1].repeat_interleave(pad, 0) if isinstance(seg, torch.Tensor) else np.repeat(seg[:1], pad, axis=0)
                seg = torch.cat([seg, rep]) if isinstance(seg, torch.Tensor) else np.concatenate([seg, rep])
            return seg

        return _tree_map(one, tree)

    def _host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def _failed_part(template: BatchResult, s: int, e: int) -> BatchResult:
        """A chunk result marking every lane failed (status 2, x = x0, NaN
        objective) with the field schema of a solved chunk."""
        x0_chunk = _host(_cut(x0s, s, e))
        part = BatchResult()
        for key, v in template.items():
            if key == "state":
                part[key] = None
            elif key in ("x0", "x", "vec_head"):
                part[key] = np.array(x0_chunk, dtype=v.dtype)
            elif (
                key == "nesterov_ratio"
                and batch_nesterov_ratio is not None
                and isinstance(v, np.ndarray)
            ):
                # The failed lanes' momentum pairs are inputs: report them.
                part[key] = _host(_cut(batch_nesterov_ratio, s, e)).astype(v.dtype)
            elif isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == K:
                shape = (K,) + (
                    ((0,) + v.shape[2:])
                    if key in ("allfuns", "allerrs", "history_mask", "allvecs")
                    else v.shape[1:]
                )
                if key == "status":
                    part[key] = np.full(shape, 2, v.dtype)
                elif key == "error_criterion":
                    part[key] = np.full(shape, np.inf, v.dtype)
                elif np.issubdtype(v.dtype, np.floating):
                    part[key] = np.full(shape, np.nan, v.dtype)
                else:  # success, nit, nit_internal, history_mask: zeros
                    part[key] = np.zeros(shape, v.dtype)
            else:
                part[key] = v
        return part

    parts: list[BatchResult] = []
    counts: list[int] = []
    fault: Exception | None = None
    fault_lane = B
    for s in range(0, B, K):
        e = min(s + K, B)
        if fault is None:
            try:
                part = minimize_proximal_gradient_batch(
                    f,
                    g,
                    jac_f,
                    prox_wsum_g,
                    _cut(x0s, s, e),
                    batch_params=(None if batch_params is None else _cut(batch_params, s, e)),
                    batch_nesterov_ratio=(
                        None
                        if batch_nesterov_ratio is None
                        else _cut(batch_nesterov_ratio, s, e)
                    ),
                    initial_states=(
                        None if initial_states is None else _cut(initial_states, s, e)
                    ),
                    keep_state=keep_state,
                    **solver_kwargs,
                )
            except torch.AcceleratorError as exc:  # how CUDA faults surface
                if s == 0:
                    # No solved chunk to take the schema from: propagate.
                    raise
                # Keep the solved chunks; mark this chunk and every later
                # lane failed without dispatching again (a device that
                # faulted may fault again).
                fault = exc
                fault_lane = s
                part = _failed_part(parts[0], s, e)
        else:
            part = _failed_part(parts[0], s, e)
        parts.append(part)
        counts.append(e - s)

    if fault is not None:
        warnings.warn(
            f"device fault at lane chunk [{fault_lane}:{B}] — returning "
            f"partial results: lanes 0:{fault_lane} solved, lanes "
            f"{fault_lane}:{B} marked status=2 (x = x0, fun = NaN). "
            f"Original error: {type(fault).__name__}: {str(fault)[:200]}",
            stacklevel=3,
        )

    first = parts[0]
    # Histories: chunks stop at different iteration counts, so every
    # history array is padded to the longest T (history_mask False).
    hist_keys = {"allfuns", "allerrs", "history_mask", "allvecs"}
    T = (
        max(np.asarray(p.allfuns).shape[1] for p in parts)
        if first.get("allfuns") is not None
        else 0
    )

    def cat(key, hist):
        segs = []
        for p, c in zip(parts, counts):
            a = np.asarray(p[key])[:c]
            if hist and a.shape[1] < T:
                widths = [(0, 0), (0, T - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
                fill = False if a.dtype == np.bool_ else np.nan
                a = np.pad(a, widths, constant_values=fill)
            segs.append(a)
        return np.concatenate(segs, axis=0)

    # Shape-driven merge: every per-lane ndarray field is concatenated,
    # global fields come from the first part.  A chunk-width ndarray field
    # that is not registered as per-lane fails loudly.
    res = BatchResult()
    for key, v in first.items():
        if key == "state":
            continue
        if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == K:
            if key not in _PER_LANE_RESULT_KEYS:
                raise RuntimeError(
                    f"lane_chunk merge: result field {key!r} is an ndarray "
                    "of chunk-width length but is not registered as "
                    "per-lane; add it to _PER_LANE_RESULT_KEYS (if it has "
                    "a leading lane axis) or keep global fields non-array"
                )
            res[key] = cat(key, key in hist_keys)
        else:
            res[key] = v
    res.time = _time.perf_counter() - start
    if fault is not None:
        res.message = (
            f"partial: device fault — lanes {fault_lane}:{B} not solved "
            f"(status=2, x = x0): {type(fault).__name__}: {str(fault)[:160]}"
        )
    if keep_state and first.get("state") is not None and fault is None:
        res.state = State(
            *(
                np.concatenate([np.asarray(a)[:c] for a, c in zip(fields, counts)], axis=0)
                for fields in zip(*(p.state for p in parts))
            )
        )
    else:
        # No resumable carry after a fault: the failed lanes have none.
        res.state = None
    return res


def minimize_proximal_gradient_batch(
    f: Callable,
    g: Callable,
    jac_f: Callable | None,
    prox_wsum_g: Callable,
    x0s: Any,
    batch_params: Any = None,
    batch_nesterov_ratio: Any = None,
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
    deprecated: bool = False,
    history: bool = False,
    history_chunk: int = 256,
    record_vecs: bool = False,
    in_sharding: Any = None,
    check_every: int = 1,
    adaptive_restart: bool = False,
    project_momentum: bool = False,
    initial_states: State | None = None,
    keep_state: bool = True,
    iter_chunk: int | None = None,
    lane_chunk: int | None = None,
    device: Any = "cuda",
) -> BatchResult:
    r"""Solve a batch of independent problems as one lane-batched solve.

    The JAX package's batch solver, with its signature and defaults, plus
    ``device``.  ``x0s`` has shape ``(B, n)``.  When ``batch_params`` is
    given (a tensor, array, or tuple/list/dict of them, each with leading
    axis ``B``), the problem callables take the lane's slice as their last
    argument: ``f(x, p)``, ``g(x, p)``, ``jac_f(x, p)``,
    ``prox_wsum_g(w, x, p)`` — λ sweeps and per-lane operators.
    ``batch_nesterov_ratio`` ``(B, 2)`` gives each lane its own momentum
    pair ``(a, b)`` and implies ``nesterov=True``.  The callables are
    written for one lane and run over all lanes by ``torch.func.vmap``: no
    host reads (``.item()``, ``bool`` of a tensor) or in-place writes inside
    them.

    The solve runs on ``x0s``'s device when it is a tensor, else on that of
    the first tensor in ``batch_params``, else on ``device`` (default
    ``"cuda"``; a machine with no card raises, ``device="cpu"`` asks for
    the CPU).

    ``history=True`` records per-iteration ``allfuns``/``allerrs``;
    ``record_vecs=True`` (implies ``history``) also the iterates
    (``allvecs``); the records are copied to the host once per
    ``history_chunk`` steps.  ``check_every`` and ``iter_chunk`` set the
    steps between host reads of "any lane active" and give bitwise the
    result of ``check_every=1``; ``lane_chunk`` solves the batch in padded
    chunks of that many lanes and merges them lane for lane (a device fault
    in a later chunk returns the solved chunks and marks the rest status
    2).  ``initial_states`` (e.g. a previous result's ``state``, tensors or
    numpy) resumes every lane; ``keep_state`` returns the final batched
    :class:`State` as numpy.  ``tol_rel`` and ``tol_internal_rel`` are the
    single solve's opt-in relative terms.  ``in_sharding`` is not ported
    (ROADMAP item 9) and raises.

    Returns a :class:`BatchResult`; per-solve views via ``.to_list()``.
    """
    start = _time.perf_counter()
    if in_sharding is not None:
        raise NotImplementedError(
            "in_sharding (placing the batch on a device mesh) is not ported to "
            "zfista_tpu_torch yet: ROADMAP.md Queue 1 item 9 (scale-out)"
        )
    dev = _solve_device(x0s, batch_params, device)
    x0s = torch.as_tensor(x0s, device=dev)
    if x0s.ndim != 2:
        raise ValueError(f"x0s must be (batch, n_features); got {tuple(x0s.shape)}")
    if tol_rel < 0:
        raise ValueError(f"tol_rel must be >= 0, got {tol_rel}")
    if tol_internal_rel < 0:
        raise ValueError(f"tol_internal_rel must be >= 0, got {tol_internal_rel}")
    # The global momentum pair as a tuple: an array-valued pair stored in the
    # result as an ndarray would be taken for a per-lane field by the merge.
    if isinstance(nesterov_ratio, torch.Tensor):
        nesterov_ratio = tuple(nesterov_ratio.detach().cpu().numpy().ravel().tolist())
    elif isinstance(nesterov_ratio, np.ndarray):
        nesterov_ratio = tuple(nesterov_ratio.ravel().tolist())
    else:
        nesterov_ratio = tuple(nesterov_ratio)
    if len(nesterov_ratio) != 2:
        raise ValueError(f"nesterov_ratio must be a pair (a, b); got {nesterov_ratio!r}")
    if not x0s.is_floating_point():
        x0s = x0s.to(torch.get_default_dtype())

    if lane_chunk is not None:
        if int(lane_chunk) < 1:
            raise ValueError(f"lane_chunk must be >= 1; got {lane_chunk}")
        if int(lane_chunk) < int(x0s.shape[0]):
            return _lane_chunked_solve(
                f,
                g,
                jac_f,
                prox_wsum_g,
                x0s,
                batch_params=batch_params,
                batch_nesterov_ratio=batch_nesterov_ratio,
                initial_states=initial_states,
                lane_chunk=int(lane_chunk),
                keep_state=keep_state,
                start=start,
                solver_kwargs=dict(
                    lr=lr,
                    tol=tol,
                    tol_rel=tol_rel,
                    tol_internal=tol_internal,
                    tol_internal_rel=tol_internal_rel,
                    max_iter=max_iter,
                    max_iter_internal=max_iter_internal,
                    max_backtrack_iter=max_backtrack_iter,
                    warm_start=warm_start,
                    decay_rate=decay_rate,
                    nesterov=nesterov,
                    nesterov_ratio=nesterov_ratio,
                    deprecated=deprecated,
                    history=history,
                    history_chunk=history_chunk,
                    record_vecs=record_vecs,
                    check_every=check_every,
                    adaptive_restart=adaptive_restart,
                    project_momentum=project_momentum,
                    iter_chunk=iter_chunk,
                    device=dev,
                ),
            )
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if iter_chunk is not None:
        iter_chunk = int(iter_chunk)
        if iter_chunk < 1:
            raise ValueError(f"iter_chunk must be >= 1, got {iter_chunk}")
        if check_every != 1 and not (history or record_vecs):
            warnings.warn(
                "check_every > 1 is ignored when iter_chunk is set (the "
                "chunked driver runs plain masked steps and re-checks "
                "between chunks).",
                stacklevel=2,
            )
    # The host copy of x0s for the result, before the device does any work.
    x0s_res = x0s.detach().cpu().numpy().copy()
    B = int(x0s.shape[0])

    params = None
    lane0: tuple = ()
    if batch_params is not None:
        params = _tree_map(lambda a: _to_device(a, dev), batch_params)
        lane0 = (_tree_map(lambda a: a[0], params),)
    # One lane's vector-form callables, the objective count from the first
    # lane (the JAX package traces eval_shape).
    f_v, g_v, jac_v, prox_v, m, scalar_mode = _normalize_problem(
        f, g, jac_f, prox_wsum_g, x0s[0], *lane0
    )

    has_ab = batch_nesterov_ratio is not None
    if has_ab:
        ab = torch.as_tensor(
            batch_nesterov_ratio.detach().cpu().numpy()
            if isinstance(batch_nesterov_ratio, torch.Tensor)
            else np.asarray(batch_nesterov_ratio),
            dtype=x0s.dtype,
            device=dev,
        )
        if tuple(ab.shape) != (B, 2):
            raise ValueError(f"batch_nesterov_ratio must be (batch, 2); got {tuple(ab.shape)}")
        # A per-lane momentum grid implies acceleration.
        nesterov = True
    if record_vecs:
        history = True  # iterate recording rides the history driver
    # Single-objective fixed-step batches with no history consumer skip the
    # per-iteration F and recompute it once at the end (bitwise the same
    # trajectory; see core.solver._make_step's track_objective).
    skip_F = decay_rate == 1 and m == 1 and not history
    max_iter = int(max_iter)

    step = _make_batch_step(
        f_v,
        g_v,
        jac_v,
        prox_v,
        m,
        params,
        tol=tol,
        tol_rel=float(tol_rel),
        tol_internal=tol_internal,
        tol_internal_rel=float(tol_internal_rel),
        max_iter_internal=int(max_iter_internal),
        max_backtrack_iter=int(max_backtrack_iter),
        warm_start=warm_start,
        decay_rate=decay_rate,
        nesterov=nesterov,
        nesterov_ratio=(ab[:, 0], ab[:, 1]) if has_ab else nesterov_ratio,
        deprecated=deprecated,
        adaptive_restart=bool(adaptive_restart),
        project_momentum=bool(project_momentum),
        track_objective=not skip_F,
        max_iter=max_iter,
    )
    v_F = _over_lanes(lambda x, *p: f_v(x, *p) + g_v(x, *p), 1, params)

    if initial_states is not None:
        states = State(*(_to_device(v, dev) for v in initial_states))
    else:
        states = _init_states(x0s, v_F(x0s), m, lr)
    any_active = lambda s: torch.any(_active(s, max_iter))

    allfuns = allerrs = hist_mask = allvecs = F0 = vec_head = None
    if history:
        if check_every != 1:
            warnings.warn(
                "check_every > 1 is ignored when history=True (the history "
                "driver records every iteration).",
                stacklevel=2,
            )
        chunk = int(history_chunk)
        if chunk < 1:
            raise ValueError(f"history_chunk must be >= 1, got {history_chunk}")
        if iter_chunk is not None:
            chunk = min(chunk, iter_chunk)
        # F at the start (F(x0), or the resume point's), first in each lane's
        # history; the resume iterate heads allvecs on a resumed run.
        F0 = states.F_x.cpu().numpy()
        if record_vecs and initial_states is not None:
            vec_head = states.x.cpu().numpy()
        states, allfuns, allerrs, hist_mask, allvecs = _run_history(
            step, states, max_iter, chunk, record_vecs
        )
    else:
        states = run_masked(
            step, states, any_active, iter_chunk if iter_chunk is not None else check_every
        )
        if skip_F:
            states = states._replace(F_x=v_F(states.x))

    host = state_to_numpy(states)
    elapsed = _time.perf_counter() - start
    return _pack_result(
        host,
        x0s_res,
        scalar_mode,
        elapsed,
        tol,
        tol_internal,
        nesterov,
        # Per-lane momentum pairs become a (B, 2) field, so to_list()
        # reports each lane's own pair.
        ab.cpu().numpy() if has_ab else nesterov_ratio,
        allfuns,
        allerrs,
        hist_mask,
        keep_state,
        allvecs=allvecs,
        F0=F0,
        vec_head=vec_head,
        tol_rel=tol_rel,
        tol_internal_rel=tol_internal_rel,
    )


def _init_states(x0s: torch.Tensor, F0: torch.Tensor, m: int, lr: float) -> State:
    """Every lane's :func:`zfista_tpu_torch.core.solver.init_state`."""
    B, dtype, dev = x0s.shape[0], x0s.dtype, x0s.device

    def lanes(v: Any, dt: torch.dtype = dtype) -> torch.Tensor:
        return torch.full((B,), v, dtype=dt, device=dev)

    return State(
        x=x0s,
        y=x0s,
        F_x=F0,
        lr=lanes(lr),
        t=lanes(1.0),
        w=torch.full((B, m), 1.0 / m, dtype=dtype, device=dev),
        err=lanes(float("inf")),
        sub_fun=lanes(0.0),
        nit=lanes(0, torch.int32),
        nit_internal=lanes(0, torch.int32),
        converged=lanes(False, torch.bool),
        failed=lanes(False, torch.bool),
    )


def _run_history(step, states: State, max_iter: int, chunk: int, record_vecs: bool):
    """The history driver: step while any lane is active (one host read per
    step), recording every lane's ``(F_x, err, recorded)`` — and ``x`` with
    ``record_vecs`` — on the device; the records go to the host once per
    ``chunk`` steps.  ``recorded`` is "active before the step and not
    failed after it", as the JAX scan driver's mask.

    Returns the final state and the histories as numpy, lane first:
    ``(B, T, m)``, ``(B, T)``, ``(B, T)``, ``(B, T, n)`` (or ``None``)."""
    pending: list[tuple] = []
    rows: list[list[np.ndarray]] = [[], [], [], []]

    def flush():
        if pending:
            for i, v in enumerate(zip(*pending)):
                rows[i].append(torch.stack(v, dim=1).cpu().numpy())
            pending.clear()

    while True:
        active = _active(states, max_iter)
        if not bool(torch.any(active)):  # the one host read per step
            break
        states = step(states)
        rec = (states.F_x, states.err, active & ~states.failed)
        pending.append(rec + ((states.x,) if record_vecs else ()))
        if len(pending) >= chunk:
            flush()
    flush()
    if not rows[0]:  # no step ran: empty histories of the right dtypes
        rows = [[v[:, None][:, :0].cpu().numpy()] for v in (states.F_x, states.err, states.failed, states.x)]
    out = [np.concatenate(r, axis=1) for r in rows[:3]]
    return (states, *out, np.concatenate(rows[3], axis=1) if record_vecs else None)


def _pack_result(
    host: State,
    x0s,
    scalar_mode,
    elapsed,
    tol,
    tol_internal,
    nesterov,
    nesterov_ratio,
    allfuns,
    allerrs,
    hist_mask,
    keep_state,
    allvecs=None,
    F0=None,
    vec_head=None,
    tol_rel=0.0,
    tol_internal_rel=0.0,
) -> BatchResult:
    """The result of a batch from its final state's host copy; status 2
    where a lane failed, else 1 where it converged, else 0."""
    converged = host.converged
    failed = host.failed
    status = np.where(failed, 2, np.where(converged, 1, 0)).astype(np.int32)
    fun = host.F_x[:, 0] if scalar_mode else host.F_x
    res = BatchResult(
        x0=x0s,
        x=host.x,
        fun=fun,
        weight=host.w,
        nit=host.nit,
        nit_internal=host.nit_internal,
        lr=host.lr,
        error_criterion=host.err,
        success=converged & ~failed,
        status=status,
        message="batched solve",
        time=elapsed,
        tol=tol,
        tol_rel=tol_rel,
        tol_internal=tol_internal,
        tol_internal_rel=tol_internal_rel,
        nesterov=nesterov,
        nesterov_ratio=nesterov_ratio,
    )
    if allfuns is not None:
        res.allfuns = allfuns
        res.allerrs = allerrs
        res.history_mask = hist_mask
        res.F0 = F0
        if allvecs is not None:
            res.allvecs = allvecs
            if vec_head is not None:
                res.vec_head = vec_head
    # The resumable batched carry (pass back as initial_states to continue
    # bitwise), or None: keep_state=False saves a host copy of the state's
    # other fields for huge-n sweeps.
    res.state = host if keep_state else None
    return res
