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
``while_loop`` into one masked loop, the port's round-based step holds
host decisions (backtracking trials, the m>=3 Newton iterations).  In the
batch they are masks: a loop runs while any lane still needs it, with one
host read per round for all lanes, and a lane that is done keeps its
values.  Not feature-sharded, the backtracking line search at m <= 2 and
every m >= 3 step (fixed ``lr`` included) also run as per-lane carried
steps (``carried_search``): one trial in every lane a step at m <= 2, one
Newton iteration of every lane's current trial at m >= 3, each lane's
search in the carry and its outcome selected on the device, so the step
reads nothing and lanes need not move in lockstep.  A lane that is not
active (converged, failed or at ``max_iter``) keeps its state, so the
drivers need no mask of their own:

* ``check_every`` / ``iter_chunk``: that many steps between host reads of
  "is any lane still active", bitwise equal to ``check_every=1``.  The
  fixed-``lr`` step at m <= 2 and, at ``check_every > 1`` without
  ``iter_chunk``, the carried steps (``check_every`` then counts them)
  read nothing, so on a card their chunks are replayed CUDA graphs
  (:func:`zfista_tpu_torch.core.solver.run_chunks`); the round-based
  steps and the CPU run eager chunks;
* history (``history=True``): on a card, replayed graphs of a few steps
  (the fixed-``lr`` step at m <= 2 or the carried steps;
  :func:`zfista_tpu_torch.core.solver._history_steps`), one read of the
  same flag per replay; elsewhere one read per step.  The per-step
  records (``F``, the error, the iterate with ``record_vecs``) stay on
  the device and are copied to the host once per ``history_chunk``
  steps; the histories are the same either way.

Per-lane problem data (a λ sweep, per-lane operators) enters through
``batch_params``, passed as the callables' last argument, and per-lane
momentum pairs through ``batch_nesterov_ratio``.  ``lane_chunk`` solves
the batch in chunks of lanes and concatenates the results.
``in_sharding`` (or a start batch that is a rank's lanes,
:func:`zfista_tpu_torch.parallel.distributed.distribute_batch`) splits the
lanes over the ``"batch"`` ranks of a mesh: each rank solves its own, as
one chunk, and every rank returns the whole batch.

Not ported: the TPU backend's width and depth auto-guards and the
compiled-driver cache (eager PyTorch compiles nothing).
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
    _history_steps,
    _make_batch_step,
    _normalize_problem,
    _over_lanes,
    _solve_device,
    _to_device,
    history_record,
    run_chunks,
    run_recorded,
    state_to_numpy,
)
from zfista_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    all_reduce_max,
    all_reduce_sum,
    batch_sharding,
    block,
    feature_sharding,
    gather,
    gather_numpy,
    lanes_on_operator,
    operator_of,
    sharding_of,
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


def _tree_leaves(tree: Any) -> list:
    """The leaves of nested tuples, lists and dicts, in order."""
    leaves: list = []
    _tree_map(leaves.append, tree)
    return leaves


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


def _sharded_solve(
    f,
    g,
    jac_f,
    prox_wsum_g,
    x0s,
    sharding: NamedSharding,
    *,
    batch_params,
    batch_nesterov_ratio,
    initial_states,
    keep_state,
    start,
    solver_kwargs,
) -> BatchResult:
    """Solve this rank's lanes of the batch along the mesh's ``"batch"``
    axis, through the same path as one chunk of :func:`_lane_chunked_solve`,
    and gather every per-lane field over the ``"batch"`` ranks: every rank
    returns the whole batch.  Lanes share nothing, so the lanes' results
    are bitwise what the unsharded batch computes for them.

    With a placement ``P("batch", "model")`` the lanes are also laid out
    by features over the ``"model"`` ranks: the callables reduce their
    products over them, and the step all-reduces each lane's sums and
    maxima over features, so the ranks of a ``"model"`` line take the same
    decisions.

    An input tagged as a rank's block (``distribute_batch``,
    ``distribute_global`` with ``P("batch", "model")``) is this rank's
    block already; any other is the whole batch, of which the rank takes
    its block.
    """
    if not isinstance(sharding, NamedSharding):
        raise TypeError(
            f"in_sharding is a placement of zfista_tpu_torch.parallel.sharding "
            f"(batch_sharding(mesh)); got {type(sharding).__name__}"
        )
    if sharding.named not in (((0, "batch"),), ((0, "batch"), (1, "model"))):
        raise ValueError(
            "in_sharding places lanes over the 'batch' axis (P('batch'), or "
            f"P('batch', 'model') with the features); got {sharding.spec!r}"
        )
    mesh = sharding.mesh
    features = feature_sharding(mesh) if len(sharding.named) == 2 else None
    lanes_sh = batch_sharding(mesh)
    k, i = mesh.size("batch"), mesh.index("batch")

    def lanes(a):
        if sharding_of(a) is not None:
            return a.view(a.shape)
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if a.shape[0] % k:
            raise ValueError(
                f"a batch of {a.shape[0]} lanes does not divide over the "
                f"mesh's {k} 'batch' ranks (pad upstream)"
            )
        n = a.shape[0] // k
        return a[i * n : (i + 1) * n]

    x0_loc = lanes(x0s)
    if features is not None and (sharding_of(x0s) is None or len(sharding_of(x0s).named) == 1):
        x0_loc = block(x0_loc.view(x0_loc.shape), NamedSharding(mesh, P(None, "model")))
    params_loc = None if batch_params is None else _tree_map(lanes, batch_params)
    part = _solve_lanes(
        f,
        g,
        jac_f,
        prox_wsum_g,
        x0_loc,
        batch_params=params_loc,
        batch_nesterov_ratio=(
            None if batch_nesterov_ratio is None else lanes(batch_nesterov_ratio)
        ),
        initial_states=None if initial_states is None else _tree_map(lanes, initial_states),
        keep_state=keep_state,
        start=start,
        features=features,
        **solver_kwargs,
    )
    dev = x0_loc.device
    hist_keys = {"allfuns", "allerrs", "history_mask", "allvecs"}
    T = 0
    if part.get("allfuns") is not None:
        # Ranks stop at different step counts: pad to the longest
        # (history_mask False), as the lane-chunk merge does.
        T = int(all_reduce_max(
            torch.tensor([float(np.asarray(part.allfuns).shape[1])], device=dev), lanes_sh.group
        )[0])
    res = BatchResult()
    for key, v in part.items():
        if key == "state":
            continue
        if key in _PER_LANE_RESULT_KEYS and isinstance(v, np.ndarray) and v.ndim >= 1:
            if key in hist_keys and v.shape[1] < T:
                widths = [(0, 0), (0, T - v.shape[1])] + [(0, 0)] * (v.ndim - 2)
                v = np.pad(v, widths, constant_values=False if v.dtype == np.bool_ else np.nan)
            res[key] = gather_numpy(v, lanes_sh, dev)
        else:
            res[key] = v
    res.state = (
        None if part.get("state") is None
        else State(*(gather_numpy(np.asarray(a), lanes_sh, dev) for a in part.state))
    )
    res.time = _time.perf_counter() - start
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
    ``history_chunk`` steps (on a card the history driver replays graphs
    of a few steps).  ``check_every`` and ``iter_chunk`` set the steps
    between host reads of "any lane active" and give bitwise the result of
    ``check_every=1``; at ``check_every > 1`` (without ``iter_chunk``) a
    backtracking batch with at most two objectives runs one line-search
    trial in every lane a step, and a batch with three or more one Newton
    iteration of every lane's current trial, and ``check_every`` then
    counts those steps; ``lane_chunk`` solves the batch in padded
    chunks of that many lanes and merges them lane for lane (a device fault
    in a later chunk returns the solved chunks and marks the rest status
    2).  ``initial_states`` (e.g. a previous result's ``state``, tensors or
    numpy) resumes every lane; ``keep_state`` returns the final batched
    :class:`State` as numpy.  ``tol_rel`` and ``tol_internal_rel`` are the
    single solve's opt-in relative terms.  ``in_sharding``
    (:func:`zfista_tpu_torch.parallel.sharding.batch_sharding` of a mesh;
    implied by an ``x0s`` that is a rank's lanes from ``distribute_batch``)
    splits the lanes of ``x0s``, ``batch_params``,
    ``batch_nesterov_ratio`` and ``initial_states`` over the mesh's
    ``"batch"`` ranks (``B`` must divide by their count); each rank solves
    its lanes and returns the whole batch, bitwise the unsharded one.
    ``P("batch", "model")`` also lays each lane out by features over the
    ``"model"`` ranks, for callables on a feature-sharded operator; the
    sweep factories' callables on a column block carry its placement
    (:func:`~zfista_tpu_torch.parallel.sharding.mark_operator`), which
    gives that placement on its mesh
    (:func:`~zfista_tpu_torch.parallel.sharding.lanes_on_operator`).
    Combining it with ``lane_chunk`` raises.

    Returns a :class:`BatchResult`; per-solve views via ``.to_list()``.
    """
    start = _time.perf_counter()
    sharding = in_sharding if in_sharding is not None else sharding_of(x0s)
    op = operator_of(f, g, jac_f, prox_wsum_g)
    if op is not None:
        # Callables on a feature-sharded operator: the lanes lie on its
        # mesh, by features too.
        sharding = lanes_on_operator(op, sharding)
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

    # What a part of the batch (a lane chunk, a rank's lanes) is solved with.
    solver_kwargs = dict(
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
    )
    if lane_chunk is not None:
        if int(lane_chunk) < 1:
            raise ValueError(f"lane_chunk must be >= 1; got {lane_chunk}")
        if sharding is not None:
            # Checked whenever lane_chunk is passed (not only when it
            # splits), as the JAX package does.
            raise ValueError(
                "lane_chunk cannot be combined with in_sharding: "
                "chunking is a single-process device-capacity knob — "
                "shard OR chunk the batch axis, not both"
            )
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
                solver_kwargs=solver_kwargs,
            )
    if sharding is not None:
        return _sharded_solve(
            f,
            g,
            jac_f,
            prox_wsum_g,
            x0s,
            sharding,
            batch_params=batch_params,
            batch_nesterov_ratio=batch_nesterov_ratio,
            initial_states=initial_states,
            keep_state=keep_state,
            start=start,
            solver_kwargs=solver_kwargs,
        )
    return _solve_lanes(
        f,
        g,
        jac_f,
        prox_wsum_g,
        x0s,
        batch_params=batch_params,
        batch_nesterov_ratio=batch_nesterov_ratio,
        initial_states=initial_states,
        keep_state=keep_state,
        start=start,
        features=None,
        **solver_kwargs,
    )


def _solve_lanes(
    f,
    g,
    jac_f,
    prox_wsum_g,
    x0s: torch.Tensor,
    *,
    batch_params,
    batch_nesterov_ratio,
    initial_states,
    keep_state,
    start,
    features: NamedSharding | None,
    lr,
    tol,
    tol_rel,
    tol_internal,
    tol_internal_rel,
    max_iter,
    max_iter_internal,
    max_backtrack_iter,
    warm_start,
    decay_rate,
    nesterov,
    nesterov_ratio,
    deprecated,
    history,
    history_chunk,
    record_vecs,
    check_every,
    adaptive_restart,
    project_momentum,
    iter_chunk,
    device,
) -> BatchResult:
    """The batch on this process: every lane of ``x0s`` (a rank's lanes
    under ``in_sharding``) through the lane-masked step.  ``features``
    (``P("model")`` on the mesh) means the lanes are this rank's feature
    blocks: the step reduces over the ``"model"`` ranks, and the result
    holds whole iterates."""
    dev = device
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
                stacklevel=3,
            )
    to_numpy = state_to_numpy
    feature_sum = feature_max = None
    if features is not None:
        group = features.group
        feature_sum = lambda v: all_reduce_sum(v, group)
        feature_max = lambda v: all_reduce_max(v, group)

        def whole(t: torch.Tensor) -> torch.Tensor:
            """The lanes' whole iterates from their feature blocks."""
            return gather(t, features, axis=t.dim() - 1)

        def to_numpy(s: State) -> State:
            return state_to_numpy(s._replace(x=whole(s.x), y=whole(s.y)))

        x0s_res = whole(x0s).cpu().numpy()
    else:
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
        feature_sum=feature_sum,
        feature_max=feature_max,
    )
    v_F = _over_lanes(lambda x, *p: f_v(x, *p) + g_v(x, *p), 1, params)

    if initial_states is not None:
        states = State(*(_to_device(v, dev) for v in initial_states))
        if features is not None:
            # Whole iterates, as a result's state holds them: this rank's block.
            split = NamedSharding(features.mesh, P(None, "model"))
            states = states._replace(x=block(states.x, split), y=block(states.y, split))
    else:
        states = _init_states(x0s, v_F(x0s), m, lr)
    any_active = lambda s: torch.any(_active(s, max_iter))
    # What the step reads by pointer: a chunk graph's cache key.
    owners = (f, g, jac_f, prox_wsum_g, *_tree_leaves(params), *((ab,) if has_ab else ()))
    # A backtracking step at m <= 2, any step at m >= 3: its line search as
    # per-lane carried steps (a trial, or a Newton iteration, a step).
    search = getattr(step, "carried_search", None)

    allfuns = allerrs = hist_mask = allvecs = F0 = vec_head = None
    if history:
        if check_every != 1:
            warnings.warn(
                "check_every > 1 is ignored when history=True (the history "
                "driver records every iteration).",
                stacklevel=3,
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
            vec_head = to_numpy(states).x
        # On a card: the fixed-lr step at m <= 2, or the carried steps, on
        # replayed graphs; else one step at a time.
        graph_step = step if search is None else search
        steps = _history_steps(graph_step, states, max_iter, owners, m)
        if steps:
            carry = states if search is None else search.start(states)
            carry, allfuns, allerrs, hist_mask, allvecs = _run_history_graphed(
                graph_step, carry, max_iter, steps, owners, chunk, record_vecs
            )
            states = carry if search is None else carry.state()
        else:
            states, allfuns, allerrs, hist_mask, allvecs = _run_history(
                step, states, max_iter, chunk, record_vecs
            )
        if features is not None and allvecs is not None:
            allvecs = gather_numpy(allvecs, features, dev, axis=2)
    elif search is not None and iter_chunk is None and check_every > 1:
        # check_every counts carried steps (iter_chunk counts iterations).
        carry = run_chunks(search, search.start(states), any_active, check_every, max_iter, owners)
        states = carry.state()
    else:
        chunk = iter_chunk if iter_chunk is not None else check_every
        states = run_chunks(step, states, any_active, chunk, max_iter, owners)
        if skip_F:
            states = states._replace(F_x=v_F(states.x))

    host = to_numpy(states)
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
    """The per-step history driver: step while any lane is active (one
    host read per step), recording every lane's ``(F_x, err, recorded)``
    — and ``x`` with ``record_vecs`` — on the device; the records go to
    the host once per ``chunk`` steps.  ``recorded`` is "active before the
    step and not failed after it", as the JAX scan driver's mask.  It
    serves the CPU, feature-sharded batches and objective counts without a
    history graph; a capturable step on a card takes
    :func:`_run_history_graphed`.

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


def _run_history_graphed(
    step, carry, max_iter: int, steps: int, owners, chunk: int, record_vecs: bool
):
    """:func:`_run_history` for a capturable step on
    :func:`~zfista_tpu_torch.core.solver.run_recorded`: ``steps`` steps a
    replayed graph, one host read of "any lane active" per replay, the
    records to the host once per ``chunk`` steps.  The histories are the
    per-step driver's, bitwise, whether a step is an iteration in every
    lane (the fixed-lr step) or a trial or a Newton iteration (the carried
    search, whose lanes do not move in lockstep): a lane's row is its iteration's, placed by
    its ``nit`` before the step that ended it (accepted or failed), and
    its rows past its last iteration hold its final values, unrecorded,
    as the per-step driver's frozen rows do.  ``T`` is the most
    iterations any lane ended, the per-step driver's step count.

    Returns the final carry and the histories, as :func:`_run_history`."""
    nit0 = carry.nit.cpu().numpy()
    kept: list[list[np.ndarray]] = []

    def sink(rows: tuple) -> None:
        ended, done, nit, *values = rows  # steps first: (S, B, ...)
        at, lane = np.nonzero(ended)
        kept.append([lane, nit[at, lane] - nit0[lane], done[at, lane], *(v[at, lane] for v in values)])

    active = lambda c: torch.any(_active(c, max_iter))  # noqa: E731
    carry = run_recorded(step, carry, active, steps, owners, history_record(record_vecs), chunk, sink)
    final = state_to_numpy(State(*carry[: len(State._fields)]))
    T = max((int(k[1].max()) + 1 for k in kept if k[1].size), default=0)
    mask = np.zeros((len(nit0), T), dtype=bool)
    hist = [
        np.repeat(v[:, None], T, axis=1)
        for v in (final.F_x, final.err) + ((final.x,) if record_vecs else ())
    ]
    for lane, row, done, *values in kept:
        mask[lane, row] = done
        for h, v in zip(hist, values):
            h[lane, row] = v
    return carry, hist[0], hist[1], mask, hist[2] if record_vecs else None


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
