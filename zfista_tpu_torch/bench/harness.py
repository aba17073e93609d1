r"""Benchmark suite: the reference's ``runtests.py`` workload on the port.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.harness`, with its
names, signatures and cache layout, plus ``device``.  For each problem in
a size sweep, solve 100 uniformly-sampled initial points with each
algorithm variant — Normal (ISTA), Accelerated (FISTA),
Accelerated-deprecated, and Accelerated-projected on bounded problems —
then compute quality metrics, performance ratios, Pareto-front and
error-decay plots, per-metric performance profiles, and a tidy CSV.

* The 100-start fan-out is one lane-batched solve per variant
  (:func:`zfista_tpu_torch.parallel.minimize_proximal_gradient_batch`),
  on the card by default.
* Results are pickled per problem cell (all variants together) as
  ``{"config", "results"}``, the JAX harness's layout.  They hold host
  values only (numpy, Python scalars), so a cache is tied to no device.
  A cell the JAX harness wrote holds ``zfista_tpu`` classes; unpickling it
  would import JAX, so the loader refuses it and re-runs the cell with a
  warning, as for a cell recorded under other settings.

CLI: ``python -m zfista_tpu_torch.bench.harness [--device cuda] [--out DIR]
[--n-samples N] [--max-iter N] [--large] [--no-plots] [--overwrite]
[--verbose] [--tol-internal-rel X]``.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import pickle
import time
import warnings
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from zfista_tpu_torch.core.result import SolveResult
from zfista_tpu_torch.core.solver import data_device
from zfista_tpu_torch.metrics import calculate_metrics
from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.models.zoo import (
    FDS,
    JOS1,
    SD,
    TOI4,
    TRIDIA,
    ZDT1,
    LinearFunctionRank1,
)
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch

logger = logging.getLogger("zfista_tpu_torch.bench")

VARIANTS = {
    "Normal": dict(nesterov=False),
    "Accelerated": dict(nesterov=True),
    "Accelerated (deprecated)": dict(nesterov=True, deprecated=True),
}

#: Extra variant for bounded problems: Nesterov with the momentum
#: extrapolation projected back into the feasible box.  The reference's
#: accelerated runs fail on every ZDT1/SD-type solve (the unprojected y
#: leaves dom(f)); this variant shows acceleration converging on the same
#: problems (see core.solver project_momentum).
PROJECTED_VARIANT = {
    "Accelerated (projected)": dict(nesterov=True, project_momentum=True),
}


def _effective_variants(problem: Problem, variants: dict | None) -> dict:
    """The variant set a run actually executes: a non-empty caller dict
    as-is; otherwise the three reference-parity variants, plus the
    projected-momentum variant for bounded problems."""
    if variants:
        return dict(variants)
    out = dict(VARIANTS)
    if getattr(problem, "bounds", None) is not None:
        out.update(PROJECTED_VARIANT)
    return out


def benchmark(
    problem: Problem,
    low,
    high,
    n_samples: int = 100,
    max_iter: int = 10_000,
    tol_internal: float = 1e-11,
    tol_internal_rel: float = 0.0,
    seed: int = 42,
    history: bool = True,
    variants: dict | None = None,
    device: Any = "cuda",
) -> dict[str, list[SolveResult]]:
    """Run the algorithm variants over ``n_samples`` uniform starts.

    The JAX harness's draw (numpy ``default_rng(seed)``, float64 starts in
    ``[low, high)``) and ``tol_internal=1e-11``, each variant one batched
    solve on ``device`` (default ``"cuda"``; a machine with no card
    raises).  ``tol_internal_rel`` (default 0, the reference accept test)
    is the single solve's opt-in relative slack.
    """
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(low, high, size=(n_samples, problem.n_features))
    variants = _effective_variants(problem, variants)
    out: dict[str, list[SolveResult]] = {}
    for name, opts in variants.items():
        t0 = time.perf_counter()
        res = minimize_proximal_gradient_batch(
            problem.f,
            problem.g,
            problem.jac_f,
            problem.prox_wsum_g,
            x0s,
            max_iter=max_iter,
            tol_internal=tol_internal,
            tol_internal_rel=tol_internal_rel,
            history=history,
            device=device,
            **opts,
        )
        logger.info(
            "%s / %s: %.2fs, %d/%d converged",
            problem.name,
            name,
            time.perf_counter() - t0,
            int(np.sum(res.success)),
            n_samples,
        )
        out[name] = res.to_list()
    return out


def _canonical_config(cfg):
    """Hashable, ``==``-safe canonical form of a run config: array-valued
    kwargs (numpy arrays or tensors on any device) make a raw dict ``==``
    raise "truth value of an array is ambiguous"."""

    def canon(v):
        if isinstance(v, dict):
            return tuple(sorted((k, canon(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(canon(x) for x in v)
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            return ("ndarray", a.shape, str(a.dtype), a.tobytes())
        if isinstance(v, np.ndarray) or (hasattr(v, "dtype") and hasattr(v, "shape")):
            a = np.asarray(v)
            return ("ndarray", a.shape, str(a.dtype), a.tobytes())
        return v

    return canon(cfg)


class _CellUnpickler(pickle.Unpickler):
    """Loads a cache cell without importing the JAX package or JAX: a
    class from ``zfista_tpu`` (the JAX harness's ``SolveResult``) or from
    ``jax`` raises instead."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("zfista_tpu", "jax", "jaxlib"):
            raise pickle.UnpicklingError(f"cache cell holds {module}.{name}")
        return super().find_class(module, name)


def load_or_run_results(
    problem: Problem,
    low,
    high,
    cache_dir: Path,
    overwrite: bool = False,
    device: Any = "cuda",
    **kwargs,
) -> dict[str, list[SolveResult]]:
    """Pickle cache with the reference's resume granularity (whole problem
    cell), as the JAX harness keeps it.

    The run configuration (sampling box + solver kwargs + the effective
    variant set) is stored beside the results; a cached cell recorded
    under different settings, or written by the JAX harness, is re-run
    with a warning instead of served stale.  ``device`` (where a re-run
    solves) is not part of the configuration, as the JAX harness does not
    record its backend.
    """
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{problem.name}.pkl"
    config = {"low": low, "high": high, **kwargs}
    # Record the EFFECTIVE variant set: the default set depends on the
    # problem (bounded cells add the projected variant).
    config["variants"] = _effective_variants(problem, kwargs.get("variants"))
    if path.exists() and not overwrite:
        try:
            payload = _CellUnpickler(io.BytesIO(path.read_bytes())).load()
        except pickle.UnpicklingError as exc:
            warnings.warn(
                f"cache for {problem.name} cannot be read here ({exc}); "
                "re-running (pass --overwrite to silence)",
                stacklevel=2,
            )
        else:
            if isinstance(payload, dict) and "results" in payload:
                if _canonical_config(payload.get("config")) == _canonical_config(
                    config
                ):
                    return payload["results"]
                warnings.warn(
                    f"cache for {problem.name} was recorded under different "
                    "settings; re-running (pass --overwrite to silence)",
                    stacklevel=2,
                )
            else:  # pre-config cache format: can't validate, honor it
                return payload
    results = benchmark(problem, low, high, device=device, **kwargs)
    with open(path, "wb") as fh:
        pickle.dump({"config": config, "results": results}, fh)
    return results


def initialize_problems(
    *,
    large: bool = False,
) -> list[tuple[Problem, float, float]]:
    """The reference's problem sweep with sampling boxes: plain + L1
    variants, ``n_features`` scaling per problem family; the JAX harness's
    list on the port's zoo.  ``large=False`` trims the biggest sizes for
    CI-scale runs."""
    jos1_sizes = [5, 10, 20, 50, 100, 200, 500, 1000] if large else [5, 50]
    zdt1_sizes = [50, 100] if large else [50]
    fds_sizes = [5, 10, 20, 50, 100] if large else [10]
    problems: list[tuple[Problem, float, float]] = []
    for n in jos1_sizes:
        problems.append((JOS1(n_features=n), -2.0, 4.0))
        problems.append(
            (
                JOS1(
                    n_features=n,
                    l1_ratios=[1.0 / n, 2.0 / n],
                    l1_shifts=[0.0, -1.0],
                ),
                -2.0,
                4.0,
            )
        )
    problems.append((SD(), 1.0, 2.0))
    for n in fds_sizes:
        problems.append((FDS(n_features=n), -2.0, 2.0))
        problems.append(
            (
                FDS(
                    n_features=n,
                    l1_ratios=[1.0 / n, 1.0 / n, 1.0 / n],
                    l1_shifts=[0.0, 1.0, -1.0],
                ),
                -2.0,
                2.0,
            )
        )
        problems.append((FDS(n_features=n, bounds=(0.0, np.inf)), 0.0, 2.0))
    for n in zdt1_sizes:
        problems.append((ZDT1(n_features=n), 0.01, 1.0))
    problems.append((TOI4(), -2.0, 5.0))
    problems.append((TOI4(l1_ratios=[0.25, 0.25], l1_shifts=[0.0, 0.0]), -2.0, 5.0))
    problems.append((TRIDIA(), -1.0, 1.0))
    problems.append(
        (TRIDIA(l1_ratios=[0.5, 0.5, 0.5], l1_shifts=[0.0, 0.0, 0.0]), -1.0, 1.0)
    )
    problems.append((LinearFunctionRank1(n_features=30), -1.0, 1.0))
    problems.append(
        (
            LinearFunctionRank1(
                n_features=30, l1_ratios=[0.01] * 4, l1_shifts=[0.0] * 4
            ),
            -1.0,
            1.0,
        )
    )
    return problems


def performance_profiles(
    ratios_per_problem: dict[str, dict[str, dict[str, float]]],
) -> dict[str, dict[str, tuple[np.ndarray, np.ndarray]]]:
    """Dolan-Moré performance profiles per metric: for each algorithm, the
    fraction of problems whose ratio-to-best is <= τ, as a step function
    of τ.

    The denominator is the TOTAL problem count, shared by every algorithm:
    a variant that runs only on a subset of problems (the projected
    variant exists only on bounded cells) counts the others as never
    solved.  NaN ratios (an all-failed cell) likewise never reach any τ.
    """
    profiles: dict[str, dict[str, tuple[np.ndarray, np.ndarray]]] = {}
    metric_names = next(iter(ratios_per_problem.values())).keys()
    n_problems = len(ratios_per_problem)
    for metric in metric_names:
        per_alg: dict[str, list[float]] = {}
        for ratios in ratios_per_problem.values():
            for alg, val in ratios[metric].items():
                per_alg.setdefault(alg, []).append(val)
        profiles[metric] = {}
        for alg, vals in per_alg.items():
            v = np.asarray(vals, dtype=float)
            v = np.sort(v[~np.isnan(v)])
            frac = np.arange(1, len(v) + 1) / n_problems
            profiles[metric][alg] = (v, frac)
    return profiles


def main(argv: Sequence[str] | None = None) -> None:
    """CLI entry: reference runtests.py semantics (``--overwrite``,
    ``--verbose``) plus ``--large``/``--out``/``--max-iter`` knobs and
    ``--device`` (default ``cuda``)."""
    parser = argparse.ArgumentParser(description="zfista_tpu_torch benchmark suite")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--large", action="store_true", help="full size sweep")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--max-iter", type=int, default=10_000)
    parser.add_argument("--n-samples", type=int, default=100)
    parser.add_argument(
        "--tol-internal-rel",
        type=float,
        default=0.0,
        help="objective-scaled line-search accept slack "
        "(default 0 = reference accept test)",
    )
    parser.add_argument("--out", type=Path, default=Path("bench_results"))
    parser.add_argument(
        "--device", default="cuda", help="where the batches solve (cuda or cpu)"
    )
    args = parser.parse_args(argv)
    try:
        data_device(args.device)
    except RuntimeError as exc:  # no card for --device cuda: say so, exit 1
        raise SystemExit(str(exc)) from None

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)
    out_dir = args.out
    cache_dir = out_dir / "cache"
    ratios_all: dict[str, dict] = {}
    rows = []
    problems = initialize_problems(large=args.large)
    try:  # tqdm progress over problem cells
        from tqdm import tqdm

        problems = tqdm(problems, desc="problems", unit="cell")
    except ImportError:
        pass
    for problem, low, high in problems:
        results = load_or_run_results(
            problem,
            low,
            high,
            cache_dir,
            overwrite=args.overwrite,
            device=args.device,
            n_samples=args.n_samples,
            max_iter=args.max_iter,
            tol_internal_rel=args.tol_internal_rel,
        )
        metrics, ratios = calculate_metrics(*results.items())
        ratios_all[problem.name] = ratios
        pdir = out_dir / problem.name
        pdir.mkdir(parents=True, exist_ok=True)
        with open(pdir / "metrics.json", "w") as fh:
            json.dump(metrics, fh, indent=2, default=float)
        for metric, per_alg in metrics.items():
            for alg, val in per_alg.items():
                rows.append(
                    dict(problem=problem.name, metric=metric, algorithm=alg, value=val)
                )
        if not args.no_plots:
            from zfista_tpu_torch.bench import plots

            plots.show_pareto_front(
                results,
                problem,
                save_to=pdir / "pareto_front.pdf",
                iteration=10,  # the reference's third front layer
            )
            plots.show_error_decay(results, save_to=pdir / "error_decay.pdf")
        print(f"{problem.name}: done")

    profiles = performance_profiles(ratios_all)
    if not args.no_plots:
        from zfista_tpu_torch.bench import plots

        plots.plot_performance_profiles(profiles, out_dir)
    try:
        import pandas as pd

        pd.DataFrame(rows).to_csv(out_dir / "metrics.csv", index=False)
    except ImportError:
        with open(out_dir / "metrics.json", "w") as fh:
            json.dump(rows, fh, indent=2, default=float)


if __name__ == "__main__":
    main()
