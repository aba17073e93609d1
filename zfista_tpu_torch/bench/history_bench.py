"""First solves of the history drivers on the card: replayed graphs of a
few steps against the per-step driver, in turns.

On a card the history drivers (a single solve's ``return_all``, a
batch's ``history=True``) replay CUDA graphs of ``HISTORY_GRAPH_STEPS[m]``
steps (:func:`zfista_tpu_torch.core.solver._history_steps`), one host read
per replay.  This bench times first solves, each from an empty graph
cache so that it pays its capture, at several steps a graph and at 0, the
per-step driver (one host read a step), and holds every run's result and
histories bitwise against the first run of its part.  Parts:

* ``lasso`` (m = 1): bench.py's LASSO (m=2000, n=10,000, float32,
  lambda 0.01) by ``Lasso.solve_fixed_step(return_all=True)`` (the fused
  step tail) and by the backtracking ``Lasso.solve(return_all=True)``
  (the carried search), each to its default tol;
* ``sweep`` (m = 1): the 1k-lambda elastic-net sweep (A 500 x 2000,
  float32, mu 0.1, lambda 1e-4..1, fixed step) with ``history=True``;
* ``harness`` (m <= 2) and ``harness_m3`` (m >= 3: FDS, TRIDIA and
  LinearFunctionRank1, a step one Newton iteration of each lane's trial):
  the harness's cells as ``benchmark()`` batches them
  (``initialize_problems(large=False)``, every variant, 100 float64
  starts, ``history=True``), per cell and summed;
* ``cli``: the harness CLI (``--no-plots --n-samples 8 --max-iter 3``,
  a fresh ``--out`` each run) on the rule's steps and on the per-step
  driver, in this process on one CPU thread, as a worker of
  ``chip_smoke.py``'s pool runs it.

Each part runs its settings (``STEPS``) in ``TURNS`` turns, the order
reversed every other turn.  Prints the card's name and power limit, then
one JSON line per part: the walls in seconds per setting, one per turn.
Card only: exits 1 without one.

Usage::

    python -m zfista_tpu_torch.bench.history_bench              # every part
    python -m zfista_tpu_torch.bench.history_bench harness_m3   # some parts
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from zfista_tpu_torch.bench._card import require_card
from zfista_tpu_torch.core import solver

#: Steps a history graph runs, per part: 0 is the per-step driver, None the
#: rule's (``HISTORY_GRAPH_STEPS`` as it stands).
STEPS: dict[str, tuple] = {
    "lasso": (0, 2, 4, 8, 16, 32),
    "sweep": (0, 2, 4, 8, 16, 32),
    "harness": (2, 4),
    "harness_m3": (0, 1, 2, 4, 8),
}
#: Settings a part runs in its first turn only: the m >= 3 cells' per-step
#: history takes 2-6 min on the longest (FDS with l1, ISTA), ~20 min in all.
ONCE: dict[str, tuple] = {
    "harness_m3": (0,),
    "cli": (None, 0),
}
TURNS = 2
LASSO_SHAPE, LASSO_LAM = (2000, 10_000), 0.01
SWEEP_SHAPE, SWEEP_LAMBDAS, SWEEP_MU = (500, 2000), 1000, 0.1
HARNESS_STARTS, HARNESS_MAX_ITER, HARNESS_TOL_INTERNAL = 100, 10_000, 1e-11
CLI_ARGS = ("--no-plots", "--n-samples", "8", "--max-iter", "3")
BATCH_KEYS = ("allfuns", "allerrs", "history_mask", "allvecs")


@contextlib.contextmanager
def history_steps(m: int, steps: int | None):
    """History graphs of ``steps`` steps at ``m`` objectives; 0: the
    per-step driver at every m; None: the rule's."""
    table = solver.HISTORY_GRAPH_STEPS
    saved = dict(table)
    if steps == 0:
        table.clear()
    elif steps is not None:
        table[m] = steps
    try:
        yield
    finally:
        table.clear()
        table.update(saved)


def first_solve(run: Callable[[], Any]) -> tuple[Any, float]:
    """``run()`` from an empty graph cache, and its wall in seconds."""
    solver._GRAPHS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same(a: list, b: list) -> bool:
    """Two lists of arrays (or None) equal bit for bit, NaN where both."""
    return all(
        (u is None and v is None)
        or (
            u is not None and v is not None and u.dtype == v.dtype
            and np.array_equal(u, v, equal_nan=u.dtype.kind == "f")
        )
        for u, v in zip(a, b)
    )


def in_turns(
    m: int, settings: Sequence, run: Callable[[], Any], arrays, turns: int, once: Sequence = ()
) -> dict:
    """First solves of ``run`` at each of ``settings`` (steps a graph) in
    ``turns`` turns, the order reversed every other turn (the settings in
    ``once`` in the first turn only): the walls per setting, the graph
    captures and replays of each setting's last run, and whether every
    run's ``arrays(result)`` equalled the first's."""
    walls: dict = {str(s): [] for s in settings}
    graphs: dict = {}
    ref, bitwise = None, True
    for t in range(turns):
        for s in settings if t % 2 == 0 else settings[::-1]:
            if t and s in once:
                continue
            before = dict(solver.graph_counts)
            with history_steps(m, s):
                out, wall = first_solve(run)
            walls[str(s)].append(wall)
            graphs[str(s)] = {k: v - before[k] for k, v in solver.graph_counts.items()}
            got = arrays(out)
            if ref is None:
                ref = got
            bitwise = bitwise and same(got, ref)
    return dict(walls=walls, graphs=graphs, bitwise=bitwise)


def single_arrays(res) -> list:
    """A single solve's result and its ``return_all`` histories."""
    return [np.asarray(res.x), np.asarray(res.nit), np.asarray(res.allvecs),
            np.asarray(res.allfuns), np.asarray(res.allerrs)]


def batch_arrays(res) -> list:
    """A batch's State and its four history arrays."""
    return [np.asarray(v) for v in res.state] + [
        None if res.get(k) is None else np.asarray(res[k]) for k in BATCH_KEYS
    ]


def lasso_part(dev, turns: int) -> dict:
    from zfista_tpu_torch.bench.gap_bench import make_problem
    from zfista_tpu_torch.models import Lasso

    A, b = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in make_problem(*LASSO_SHAPE)[:2])
    prob = Lasso(A, b, LASSO_LAM)
    x0 = torch.zeros(LASSO_SHAPE[1], dtype=torch.float32, device=dev)
    prob.solve_fixed_step(x0, max_iter=2)  # 1/L cached, first-use costs
    runs = {
        "solve_fixed_step(return_all=True)": lambda: prob.solve_fixed_step(x0, return_all=True),
        "solve(nesterov=True, return_all=True)": lambda: prob.solve(x0, nesterov=True, return_all=True),
    }
    out = {}
    for name, run in runs.items():
        out[name] = in_turns(1, STEPS["lasso"], run, single_arrays, turns)
        out[name]["nit"] = int(run().nit)
    return out


def sweep_part(dev, turns: int) -> dict:
    from zfista_tpu_torch.bench.gap_bench import make_problem
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    A, b = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in make_problem(*SWEEP_SHAPE)[:2])
    lams = torch.as_tensor(np.logspace(-4, 0, SWEEP_LAMBDAS).astype(np.float32), device=dev)
    lr = 1.0 / Lasso(A, b, 1.0, l2_ratio=SWEEP_MU).lipschitz()
    fns = make_lasso_lambda_sweep(A, b, l2_ratio=SWEEP_MU)
    x0s = torch.zeros((SWEEP_LAMBDAS, SWEEP_SHAPE[1]), dtype=torch.float32, device=dev)
    kw = dict(batch_params=lams, lr=lr, decay_rate=1, nesterov=True)
    minimize_proximal_gradient_batch(*fns, x0s, max_iter=2, history=True, **kw)  # first-use costs

    def run():
        return minimize_proximal_gradient_batch(*fns, x0s, max_iter=HARNESS_MAX_ITER, history=True, **kw)

    out = in_turns(1, STEPS["sweep"], run, batch_arrays, turns)
    out["nit_max"] = int(np.max(run().nit))
    return out


def harness_part(dev, turns: int, part: str = "harness") -> dict:
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    cells = {}
    totals = {str(s): [0.0] * (1 if s in ONCE.get(part, ()) else turns) for s in STEPS[part]}
    for p, low, high in initialize_problems(large=False):
        if (p.n_objectives > 2) != (part == "harness_m3"):
            continue
        x0s = np.random.default_rng(42).uniform(low, high, size=(HARNESS_STARTS, p.n_features))
        for variant, opts in _effective_variants(p, None).items():
            def run(opts=opts, x0s=x0s, p=p):
                return minimize_proximal_gradient_batch(
                    p.f, p.g, p.jac_f, p.prox_wsum_g, x0s, max_iter=HARNESS_MAX_ITER,
                    tol_internal=HARNESS_TOL_INTERNAL, history=True, device=dev, **opts,
                )

            cell = in_turns(p.n_objectives, STEPS[part], run, batch_arrays, turns,
                            ONCE.get(part, ()))
            cells[f"{p.name} / {variant}"] = cell
            print(json.dumps({"part": part, "cell": f"{p.name} / {variant}", **cell}), flush=True)
            for s, ws in cell["walls"].items():
                totals[s] = [a + w for a, w in zip(totals[s], ws)]
    bitwise = all(c["bitwise"] for c in cells.values())
    return dict(totals=totals, bitwise=bitwise, cells={k: c["walls"] for k, c in cells.items()})


def cli_part(dev, turns: int) -> dict:
    from zfista_tpu_torch.bench import harness

    torch.set_num_threads(1)

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--device", str(dev), *CLI_ARGS, "--out", tmp]
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
                harness.main(argv)

    return in_turns(2, STEPS["cli"], run, lambda _: [], turns)


PARTS = {
    "lasso": lasso_part,
    "sweep": sweep_part,
    "harness": harness_part,
    "harness_m3": lambda dev, turns: harness_part(dev, turns, "harness_m3"),
    "cli": cli_part,
}


def main(argv: Sequence[str] | None = None) -> dict:
    """Run the parts named in ``argv`` (default: every part)."""
    names = list(sys.argv[1:] if argv is None else argv) or list(PARTS)
    unknown = [n for n in names if n not in PARTS]
    if unknown:
        raise SystemExit(f"history_bench: unknown parts {unknown} (parts: {', '.join(PARTS)})")
    print(require_card("zfista_tpu_torch.bench.history_bench"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    out = {}
    for name in names:
        part = PARTS[name]
        t0 = time.perf_counter()
        out[name] = part(dev, TURNS)
        out[name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"part": name, "rule": dict(solver.HISTORY_GRAPH_STEPS), **out[name]}), flush=True)
    return out


if __name__ == "__main__":
    main()
