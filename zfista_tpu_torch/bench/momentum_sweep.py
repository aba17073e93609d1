r"""Generalized-momentum (a, b) sweep experiments — the papers' headline runs.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.momentum_sweep`, with
its names and signatures plus ``device``.  Reference workloads
(examples/PGM_experiment_with_various_a_b.ipynb and
examples/cameraman.ipynb): for each momentum pair in a 15-point grid over
``t_{k+1} = sqrt(t_k^2 - a t_k + b) + 1/2``, solve many random starts and
report mean wall time and mean iterations to tolerance, written as CSV rows
``a, b, time, nit`` (examples/data/*_ab.csv).

The whole grid x starts product is one lane-batched solve on the device:
each lane carries its own ``(a, b)`` as data (``batch_nesterov_ratio``),
so 15 pairs x 1000 starts = 15000 lanes advance together.
"""

from __future__ import annotations

import time
from fractions import Fraction
from pathlib import Path
from typing import Any

import numpy as np

from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch

#: The reference's 15 momentum pairs (examples/data/*_ab.csv row keys):
#: for each a in {0, 1/6, 1/4, 1/2, 3/4}, three b values between the
#: theoretical bounds b_min = a^2/4 (discriminant) and b_max = 1/4.
AB_GRID: list[tuple[Fraction, Fraction]] = [
    (Fraction(0), Fraction(0)),
    (Fraction(0), Fraction(1, 8)),
    (Fraction(0), Fraction(1, 4)),
    (Fraction(1, 6), Fraction(1, 144)),
    (Fraction(1, 6), Fraction(37, 288)),
    (Fraction(1, 6), Fraction(1, 4)),
    (Fraction(1, 4), Fraction(1, 64)),
    (Fraction(1, 4), Fraction(17, 128)),
    (Fraction(1, 4), Fraction(1, 4)),
    (Fraction(1, 2), Fraction(1, 16)),
    (Fraction(1, 2), Fraction(5, 32)),
    (Fraction(1, 2), Fraction(1, 4)),
    (Fraction(3, 4), Fraction(9, 64)),
    (Fraction(3, 4), Fraction(25, 128)),
    (Fraction(3, 4), Fraction(1, 4)),
]


def momentum_sweep(
    problem: Problem,
    low,
    high,
    n_starts: int = 100,
    ab_grid: list[tuple] | None = None,
    seed: int = 42,
    max_iter: int = 10_000,
    lane_chunk: int | None = None,
    x0s: np.ndarray | None = None,
    measure_times: bool = True,
    device: Any = "cuda",
    **solver_kwargs,
):
    """Run the full (a, b) x starts grid as one batched solve.

    Returns ``(rows, result)`` where ``rows`` is a list of dicts
    ``{a, b, time, nit, error_rate}`` and ``result`` is the raw
    :class:`~zfista_tpu_torch.parallel.batch.BatchResult` of the shared sweep,
    solved on ``device`` (default ``"cuda"``; a machine with no card
    raises).

    ``time`` semantics: with ``measure_times=True`` (default) each pair is
    re-run as its OWN timed batch over the same starts after the shared
    sweep, and ``time`` is the measured wall seconds divided by
    ``n_starts`` — i.e. measured mean seconds per solve, the reference
    CSVs' column semantics (examples/data/JOS1_ab.csv), amortized over the
    lane-batched solve; the timed batches run with ``keep_state=False`` and
    no history, after one untimed warm-up batch.  With
    ``measure_times=False``, ``time`` falls back to a MODELED attribution of the single shared wall clock (proportional to
    mean iteration count).  Pairs with no successful start carry
    ``time=nit=None``.

    ``x0s`` overrides the uniform-box start sampling with explicit starts
    of shape ``(n_starts, n_features)`` (e.g. the deblurring example's
    single deterministic start).
    """
    grid = ab_grid if ab_grid is not None else AB_GRID
    if x0s is None:
        rng = np.random.default_rng(seed)
        x0s = rng.uniform(low, high, size=(n_starts, problem.n_features))
    else:
        x0s = np.asarray(x0s)
        if x0s.shape != (n_starts, problem.n_features):
            raise ValueError(
                f"x0s must be ({n_starts}, {problem.n_features}); got {x0s.shape}"
            )
    # lanes = grid x starts (grid-major, so lane // n_starts indexes the pair)
    x0_lanes = np.tile(x0s, (len(grid), 1))
    ab_lanes = np.repeat(
        np.asarray([[float(a), float(b)] for a, b in grid]), n_starts, axis=0
    )

    # lane_chunk bounds the width of each batch; chunking, tail padding and
    # lane-for-lane result merging live in the batch API itself
    # (minimize_proximal_gradient_batch(lane_chunk=...)), which this
    # harness forwards the knob to.
    # nesterov defaults True (a momentum sweep), but stays overridable:
    # an explicit nesterov= in solver_kwargs must not collide with a
    # positional duplicate.
    solver_kwargs.setdefault("nesterov", True)
    t0 = time.perf_counter()
    res = minimize_proximal_gradient_batch(
        problem.f,
        problem.g,
        problem.jac_f,
        problem.prox_wsum_g,
        x0_lanes,
        batch_nesterov_ratio=ab_lanes,
        max_iter=max_iter,
        lane_chunk=lane_chunk,
        device=device,
        **solver_kwargs,
    )
    total = time.perf_counter() - t0

    nit = np.asarray(res.nit).reshape(len(grid), n_starts)
    ok = np.asarray(res.success).reshape(len(grid), n_starts)
    n_ok = ok.sum(axis=1)
    sum_nit = np.where(ok, nit, 0).sum(axis=1)
    mean_nit = np.divide(
        sum_nit, n_ok, out=np.full(len(grid), np.nan), where=n_ok > 0
    )

    if measure_times:
        # MEASURED per-pair seconds: each pair re-run as its own timed
        # batch over the same starts.  History/recording kwargs are
        # stripped so the measurement times the solver, not host-side
        # history collection; an untimed warm-up run pays the first-use
        # costs (library handles, allocator pools).
        pair_kwargs = {
            k: v
            for k, v in solver_kwargs.items()
            if k not in ("history", "record_vecs", "history_chunk", "keep_state")
        }
        # keep_state=True (the default) keeps the full per-lane State (x
        # and y for every lane) in the result — solver time only, so drop
        # it from the measurement.
        pair_kwargs["keep_state"] = False

        def run_pair(a, b):
            # Chunking/padding delegates to the batch API's lane_chunk
            # (one tested implementation); timing includes the host-side
            # chunk merge, which for the no-history per-pair runs is a few
            # tiny array concatenations — noise next to the solve.
            ab_c = np.repeat(
                np.asarray([[float(a), float(b)]]), n_starts, axis=0
            )
            t_start = time.perf_counter()
            minimize_proximal_gradient_batch(
                problem.f,
                problem.g,
                problem.jac_f,
                problem.prox_wsum_g,
                x0s,
                batch_nesterov_ratio=ab_c,
                max_iter=max_iter,
                lane_chunk=lane_chunk,
                device=device,
                **pair_kwargs,
            )
            return time.perf_counter() - t_start

        run_pair(*grid[0])  # warm-up, untimed
        measured_wall = [run_pair(a, b) for a, b in grid]
        per_solve_time = [w / n_starts for w in measured_wall]
    else:
        # MODELED attribution of the single shared wall clock,
        # proportional to mean iteration count (lanes run in lockstep, so
        # no per-pair wall exists in the shared sweep).
        denom = np.nansum(mean_nit)
        # Each pair's share of the shared wall covers ALL of its n_starts
        # lockstep lanes; divide so the column carries the same
        # seconds-per-SOLVE semantics as the measured branch (and the
        # reference CSVs).
        per_solve_time = [
            float(total * mean_nit[i] / denom / n_starts)
            if n_ok[i] > 0
            else None
            for i in range(len(grid))
        ]

    rows = []
    for i, (a, b) in enumerate(grid):
        failed_all = n_ok[i] == 0
        rows.append(
            dict(
                a=str(a),
                b=str(b),
                time=None if failed_all else float(per_solve_time[i]),
                nit=None if failed_all else float(mean_nit[i]),
                error_rate=float(1 - ok[i].mean()),
            )
        )
    return rows, res


def write_ab_csv(rows, path: Path) -> None:
    """Write the reference's CSV row format ``a ,b,time,nit``
    (examples/data/JOS1_ab.csv:1-15).

    The ``time`` column carries whatever :func:`momentum_sweep` produced:
    measured mean seconds per solve with ``measure_times=True`` (the
    reference CSVs' semantics), or the modeled shared-wall attribution
    with ``measure_times=False``.  All-failed pairs write empty time/nit
    fields.

    Time precision: at least 3 decimals (the reference's format) but
    never fewer than 3 significant digits, so per-solve times below 0.5 ms
    (every SD row) stay nonzero; the JAX writer's format, byte for byte.
    Values stay plain decimal (no exponent), so reference-style CSV
    consumers parse them unchanged."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def fmt_time(v: float) -> str:
        import math

        if v == 0.0:
            return "0.000"
        if v >= 0.1:
            return f"{v:.3f}"
        # Decimals from the value's magnitude, NOT from "first nonzero
        # rounding": rounding 7.3e-5 at 4 decimals already yields the
        # nonzero '0.0001', which undershoots the significant digits for
        # every value in [0.5, 1.0)x10^-k.
        decimals = -math.floor(math.log10(abs(v))) + 2  # 3 sig digits
        return f"{v:.{max(decimals, 3)}f}"

    with open(path, "w") as fh:
        for r in rows:
            t = "" if r["time"] is None else fmt_time(float(r["time"]))
            n = "" if r["nit"] is None else round(r["nit"], 3)
            fh.write(f"{r['a']} ,{r['b']},{t},{n}\n")
