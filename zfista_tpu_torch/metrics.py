r"""Pareto-front quality metrics, implemented natively (no pymoo/scipy).

PyTorch-port counterpart of :mod:`zfista_tpu.metrics`, unchanged: it is
host numpy code there too, and takes host arrays (a batch's results are
numpy already).  Its native kernels are the port's own copy
(:mod:`zfista_tpu_torch.native`).

Behavioral parity with the reference's metrics layer
(reference: zfista/metrics.py:11-199), which delegates non-dominated sorting
and hypervolume to ``pymoo``.  Here both are built from scratch:

* non-dominated filtering — vectorized pairwise domination in numpy
  (fronts are ≤ a few hundred points; O(N²m) is instant);
* hypervolume — the WFG exclusive-hypervolume recursion with a closed-form
  2-objective fast path, after the same ideal/nadir normalization pymoo
  applies when constructed from a reference front (``Hypervolume(pf=...)``:
  zero-to-one normalize by the true front's ideal/nadir, reference point =
  the normalized nadir, i.e. the all-ones corner).

``calculate_metrics`` reproduces the reference's outputs (metric dict +
per-metric performance ratios vs best, zfista/metrics.py:103-199) including
the ``nit_internal`` average that the reference's own solver never emitted
(SURVEY.md §2.3 — our solver does).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from zfista_tpu_torch.core.result import SolveResult

__all__ = [
    "extract_function_values",
    "extract_non_dominated_points",
    "non_dominated_mask",
    "hypervolume",
    "purity",
    "spread_metrics",
    "calculate_metrics",
]


def extract_function_values(res: Sequence[Any]) -> np.ndarray:
    """Stack ``res.fun`` over runs into an ``(N, m)`` array
    (reference: zfista/metrics.py:11-25)."""
    return np.vstack([np.atleast_1d(np.asarray(r.fun)) for r in res])


def non_dominated_mask(F: np.ndarray) -> np.ndarray:
    """Boolean mask of Pareto-efficient rows of ``F`` (minimization).

    A point is dominated iff some other point is <= in every objective and
    < in at least one.  Duplicate points are all kept (they tie), matching
    the sorting behavior the reference relies on for its set intersections.

    Large inputs route to the native C++ kernel
    (:mod:`zfista_tpu_torch.native`: O(N log N) for m=2, no N² memory in
    general); small inputs and toolchain-less environments use the
    vectorized numpy path below.
    """
    F = np.asarray(F, dtype=float)
    n = len(F)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if n > 512:
        from zfista_tpu_torch.native import nd_mask_native

        mask = nd_mask_native(F)
        if mask is not None:
            return mask
    le = np.all(F[:, None, :] <= F[None, :, :], axis=-1)  # i dominates-or-ties j
    lt = np.any(F[:, None, :] < F[None, :, :], axis=-1)
    dominates = le & lt  # strict Pareto domination i -> j
    return ~dominates.any(axis=0)


def extract_non_dominated_points(F: np.ndarray) -> np.ndarray:
    """Rows of ``F`` on the (first) non-dominated front, original order
    (reference: zfista/metrics.py:28-44)."""
    return np.asarray(F, dtype=float)[non_dominated_mask(F)]


def _hv_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-objective hypervolume by a sweep over f1-sorted points."""
    pts = points[np.argsort(points[:, 0], kind="stable")]
    hv = 0.0
    prev_f2 = ref[1]
    for f1, f2 in pts:
        if f2 < prev_f2:
            hv += (ref[0] - f1) * (prev_f2 - f2)
            prev_f2 = f2
    return hv


def _wfg(points: np.ndarray, ref: np.ndarray) -> float:
    """WFG exclusive-hypervolume recursion (While et al., 2012)."""
    if len(points) == 0:
        return 0.0
    if points.shape[1] == 2:
        return _hv_2d(points, ref)
    # Sort worst-first on the last objective for better pruning.
    pts = points[np.argsort(-points[:, -1], kind="stable")]
    hv = 0.0
    for i in range(len(pts)):
        p = pts[i]
        inclusive = float(np.prod(ref - p))
        rest = pts[i + 1 :]
        if len(rest):
            limited = np.maximum(rest, p)
            limited = limited[non_dominated_mask(limited)]
            hv += inclusive - _wfg(limited, ref)
        else:
            hv += inclusive
    return hv


def hypervolume(
    F: np.ndarray,
    front_true: np.ndarray | None = None,
    ref_point: np.ndarray | None = None,
) -> float:
    """Hypervolume of the non-dominated subset of ``F``.

    With ``front_true`` given (the reference's usage,
    zfista/metrics.py:144): zero-to-one normalize by the true front's
    ideal/nadir and measure against the all-ones corner.  With an explicit
    ``ref_point``: measure unnormalized against it.

    .. note:: Parity scope.  The reference delegates to
       ``pymoo.indicators.hv.Hypervolume(pf=front_true)``; depending on the
       installed pymoo's ``zero_to_one`` default, its ABSOLUTE value may be
       this one times the constant ``prod(nadir - ideal)`` of the true
       front (an axis-aligned affine rescaling).  Per-problem performance
       RATIOS between algorithms — the quantity the reference's benchmark
       reports and compares — are identical under either convention.
       pymoo is not available in this build environment; ABSOLUTE values
       are instead pinned against an independent exact algorithm (z-slice
       sweep) and hand-computed golden constants under both conventions,
       with the conversion factor asserted exactly
       (tests/test_metrics.py::test_hypervolume_golden_constants).
    """
    F = np.atleast_2d(np.asarray(F, dtype=float))
    pts = extract_non_dominated_points(F)
    if front_true is not None:
        ft = np.asarray(front_true, dtype=float)
        ideal = ft.min(axis=0)
        nadir = ft.max(axis=0)
        scale = np.where(nadir > ideal, nadir - ideal, 1.0)
        pts = (pts - ideal) / scale
        ref = np.ones(F.shape[1])
    elif ref_point is not None:
        ref = np.asarray(ref_point, dtype=float)
    else:
        raise ValueError("provide front_true or ref_point")
    # Only points strictly better than the reference corner contribute.
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) > 64:
        from zfista_tpu_torch.native import hypervolume_native

        hv = hypervolume_native(pts, ref)
        if hv is not None:
            return hv
    if pts.shape[-1] > 2 and len(pts) > 500:
        # The WFG limited-set recursion can reach one frame per point; lift
        # the interpreter limit for toolchain-less fallbacks on big fronts.
        import sys

        limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(limit, 10 * len(pts) + 1000))
        try:
            return float(_wfg(pts, ref))
        finally:
            sys.setrecursionlimit(limit)
    return float(_wfg(pts, ref))


def purity(front: np.ndarray, front_true: np.ndarray) -> float:
    """``|front| / |front_true|`` — callers pass the intersection as
    ``front`` (reference: zfista/metrics.py:47-63,134)."""
    return len(front) / len(front_true)


def spread_metrics(
    front: np.ndarray, front_true: np.ndarray
) -> tuple[float, float]:
    """Γ (max gap) and Δ (gap uniformity) along each objective axis
    (reference: zfista/metrics.py:66-100).  ``(inf, inf)`` for fronts with
    fewer than two points."""
    front = np.atleast_2d(np.asarray(front, dtype=float))
    front_true = np.atleast_2d(np.asarray(front_true, dtype=float))
    if len(front) <= 1:
        return np.inf, np.inf
    gamma = 0.0
    delta = 0.0
    for j in range(front_true.shape[1]):
        F_j = np.sort(front[:, j])
        d_start = F_j[0] - front_true[:, j].min()
        d_end = front_true[:, j].max() - F_j[-1]
        gaps = np.diff(F_j)
        gamma = max(gamma, float(np.max(gaps)), float(d_start), float(d_end))
        avg = np.mean(gaps)
        num = d_start + d_end + np.sum(np.abs(gaps - avg))
        den = d_start + d_end + (len(F_j) - 1) * avg
        delta = max(delta, float(num / den))
    return gamma, delta


def _ratio(values: dict[str, float], maximize: bool) -> dict[str, float]:
    # The best is taken over FINITE-OR-DEFINED entries only: a NaN value
    # (e.g. Avg time of a variant with zero successful runs) would
    # otherwise poison min()/max() order-dependently (NaN comparisons are
    # False, so whichever insertion order puts the NaN first wins) and
    # turn EVERY variant's ratio NaN.  NaN entries keep a NaN ratio.
    valid = [v for v in values.values() if not np.isnan(v)]
    if not valid:
        return {k: np.nan for k in values}
    if maximize:
        best = max(valid)
        return {
            k: (
                np.nan
                if np.isnan(v)
                else (best / v if v != 0 else (np.inf if best != 0 else 1))
            )
            for k, v in values.items()
        }
    best = min(valid)
    return {
        k: (
            np.nan
            if np.isnan(v)
            else (v / best if best != 0 else (np.inf if v != 0 else 1))
        )
        for k, v in values.items()
    }


def calculate_metrics(
    *named_results: tuple[str, Sequence[SolveResult]],
) -> tuple[dict[str, dict[str, float]], dict[str, dict[str, float]]]:
    """Quality + cost metrics and per-metric performance ratios vs best.

    Output structure and semantics match the reference
    (zfista/metrics.py:103-199): the "true" front is pooled from the union
    of all algorithms' fronts; Purity/Γ/Δ are computed on each algorithm's
    intersection with that pooled front; averages are over successful runs.

    .. note:: With results from the batched driver, each lane's ``time`` is
       the batch wall clock divided evenly across lanes
       (``BatchResult.to_list``), so "Avg computation time" is a per-batch
       constant — comparable BETWEEN variants of the same batch shape, not
       a per-solve measurement like the reference's per-process timing.
    """
    names, results = zip(*named_results)
    # Deliberate divergence from the reference (tracked): rows with a
    # non-finite objective (a diverged/NaN lane, or an indicator-g +inf)
    # are dropped before front pooling.  One NaN row would otherwise
    # poison the pooled front's ideal/nadir and silently zero EVERY
    # algorithm's hypervolume; one +inf row makes the normalization scale
    # infinite with the same effect.  (The reference pools unfiltered and
    # inherits exactly this failure through pymoo's normalization.)
    def _finite_front(r):
        vals = extract_function_values(r)
        return extract_non_dominated_points(
            vals[np.isfinite(vals).all(axis=1)]
        )

    fronts = [_finite_front(r) for r in results]
    front_true = extract_non_dominated_points(np.concatenate(fronts, axis=0))
    true_set = {tuple(p) for p in front_true}

    intersections = []
    for front in fronts:
        inter = [p for p in front if tuple(p) in true_set]
        # de-duplicate, preserving the set semantics of the reference
        uniq = list({tuple(p): p for p in inter}.values())
        intersections.append(
            np.array(uniq) if uniq else np.empty((0, front_true.shape[1]))
        )

    if len(front_true):
        hvs = [hypervolume(front, front_true=front_true) for front in fronts]
        purities = [purity(i, front_true) for i in intersections]
        spreads = [spread_metrics(i, front_true) for i in intersections]
    else:
        # every run of every algorithm produced a non-finite objective:
        # no front exists to measure against
        hvs = [np.nan] * len(fronts)
        purities = [np.nan] * len(fronts)
        spreads = [(np.nan, np.nan)] * len(fronts)
    gammas = [s[0] for s in spreads]
    deltas = [s[1] for s in spreads]
    err_rates = [float(np.mean([not r.success for r in rl])) for rl in results]

    def _avg(rl, field):
        vals = [r[field] for r in rl if r.success]
        return float(np.mean(vals)) if vals else np.nan

    metrics = {
        "Hypervolume": dict(zip(names, hvs)),
        "Gamma": dict(zip(names, gammas)),
        "Delta": dict(zip(names, deltas)),
        "Purity": dict(zip(names, purities)),
        "Error rate": dict(zip(names, err_rates)),
        "Avg computation time": dict(
            zip(names, [_avg(rl, "time") for rl in results])
        ),
        "Avg iterations": dict(zip(names, [_avg(rl, "nit") for rl in results])),
        "Avg internal iterations": dict(
            zip(names, [_avg(rl, "nit_internal") for rl in results])
        ),
    }
    ratios = {
        key: _ratio(vals, maximize=key in ("Hypervolume", "Purity"))
        for key, vals in metrics.items()
    }
    return metrics, ratios
