"""Plotting for the benchmark harness (Pareto fronts, error decay,
performance profiles) — matplotlib-gated, headless-safe.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.plots`: the same
figures from the port's (host numpy) results.  Matplotlib is imported at
the first plot, so a machine without it fails there with the ImportError.

Reference equivalents: show_Pareto_front (benchmarks/benchmark.py:78-222),
show_error_decay (225-249), plot_performance_profiles (396-408).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from zfista_tpu_torch.metrics import extract_function_values


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _F_host(problem, x0) -> np.ndarray:
    """F(x0) = f(x0) + g(x0) on the CPU, as numpy."""
    x = torch.as_tensor(np.asarray(x0))
    return (problem.f(x) + problem.g(x)).numpy()


def show_pareto_front(
    results, problem, save_to: Path | None = None, iteration: int | None = None
):
    """Scatter initial vs final (and optionally the k-th-iterate) objective
    fronts per algorithm (2D/3D per n_objectives; reference
    benchmark.py:78-222 plots the same three layers)."""
    plt = _plt()
    m = problem.n_objectives
    if m not in (2, 3):
        return None
    fig = plt.figure(figsize=(5, 4))
    ax = fig.add_subplot(111, projection="3d" if m == 3 else None)
    first = next(iter(results.values()))
    # initial front: F(x0).  Use allfuns[0] (= F(x0) on both the single
    # and batched history paths) when available; recompute only for
    # results without history.
    F0 = np.vstack(
        [
            np.asarray(r.allfuns[0])
            if getattr(r, "allfuns", None)
            # F = f + g: the history path records the full composite value,
            # so the no-history fallback must too (g can be nonzero — L1 /
            # indicator variants).
            else _F_host(problem, r.x0)
            for r in first
        ]
    )
    ax.scatter(*F0.T[:m], s=8, marker="x", c="gray", label="initial", alpha=0.5)
    for name, res_list in results.items():
        # k-th-iterate layer: allfuns[k] is the value after k iterations
        # (allfuns[0] = F(x0)), runs with fewer iterations are skipped —
        # reference semantics (benchmark.py:141-149).
        with_hist = [
            r
            for r in res_list
            if r.get("allfuns") and iteration is not None and r.nit >= iteration
        ]
        if with_hist:
            Fk = np.vstack(
                [np.atleast_1d(r.allfuns[iteration]) for r in with_hist]
            )
            ax.scatter(
                *Fk.T[:m],
                s=8,
                label=f"{name} ({iteration} iters)",
                alpha=0.6,
                facecolors="none",
                edgecolors=f"C{list(results).index(name)}",
            )
        F = extract_function_values(res_list)
        ax.scatter(*F.T[:m], s=8, label=name, alpha=0.7)
    ax.set_xlabel("$F_1$")
    ax.set_ylabel("$F_2$")
    if m == 3:
        ax.set_zlabel("$F_3$")
    ax.legend(fontsize=7)
    ax.set_title(problem.name, fontsize=8)
    fig.tight_layout()
    if save_to is not None:
        fig.savefig(save_to)
        plt.close(fig)
    return fig


def show_error_decay(results, save_to: Path | None = None):
    """Log-scale ||x^k - y^k||_inf decay per algorithm, median over runs
    (reference benchmark.py:225-249 plots per-run curves; the batched
    driver's history supplies the same series)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4))
    for name, res_list in results.items():
        curves = [np.asarray(r.allerrs) for r in res_list if r.get("allerrs")]
        if not curves:
            continue
        T = max(len(c) for c in curves)
        padded = np.full((len(curves), T), np.nan)
        for i, c in enumerate(curves):
            padded[i, : len(c)] = c
        med = np.nanmedian(padded, axis=0)
        ax.semilogy(np.arange(1, T + 1), med, label=name)
    ax.set_xlabel("iteration $k$")
    ax.set_ylabel(r"$\|x^k - y^k\|_\infty$ (median)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    if save_to is not None:
        fig.savefig(save_to)
        plt.close(fig)
    return fig


def plot_performance_profiles(profiles, out_dir: Path):
    """Step plots of the Dolan-Moré profiles per metric
    (reference benchmark.py:396-408)."""
    plt = _plt()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for metric, per_alg in profiles.items():
        fig, ax = plt.subplots(figsize=(5, 4))
        for alg, (tau, frac) in per_alg.items():
            finite = np.isfinite(tau)
            ax.step(tau[finite], frac[finite], where="post", label=alg)
        ax.set_xlabel(r"performance ratio $\tau$")
        ax.set_ylabel("fraction of problems")
        ax.set_title(metric, fontsize=9)
        ax.legend(fontsize=7)
        fig.tight_layout()
        slug = metric.lower().replace(" ", "_")
        fig.savefig(out_dir / f"performance_profile_{slug}.pdf")
        plt.close(fig)
