"""Adaptive-restart benchmark: ``adaptive_restart=True`` vs plain FISTA.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.restart_bench`, with
its names and signatures plus ``device``.  Per problem it records
iterations-to-tolerance and wall time with the flag off and on, through
the PUBLIC entry points (``Lasso.solve_fixed_step``, ``TVDeblur.solve``,
``minimize_proximal_gradient_batch``), plus the final host-float64
objective so a speedup cannot hide a quality loss.

On the card the LASSO row without restart runs the fused kernel's
``lasso_step_tail`` (one launch per step); ``adaptive_restart=True``
leaves that seam, so the restart row runs the solver's generic step.  The
TV rows run the TV prox's CUDA kernel (the whole-image FGP kernel at
256²).

Usage::

    python -m zfista_tpu_torch.bench.restart_bench            # full table
    python -m zfista_tpu_torch.bench.restart_bench --repeats 5 --skip tridia
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from zfista_tpu_torch.core.solver import data_device


def _timed(solve, repeats: int):
    """(result, best wall seconds) — result from the warm-up call."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    res = solve()  # warm-up
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        r = solve()
        best = min(best, time.perf_counter() - t0)
    del r
    return res, best


def bench_lasso(repeats: int, tol: float = 1e-6, device: Any = "cuda") -> list[dict]:
    """Headline dense LASSO (gap_bench's problem, float32), fixed step,
    tol-based."""
    from zfista_tpu_torch.bench.gap_bench import lipschitz_np, make_problem
    from zfista_tpu_torch.models.lasso import Lasso

    A, b, lam = make_problem(2000, 10000)
    lr = 1.0 / lipschitz_np(A)
    prob = Lasso(A, b, l1_ratio=lam, device=device)
    A64, b64 = np.asarray(A, np.float64), np.asarray(b, np.float64)

    def F_host(x):
        r = A64 @ np.asarray(x, np.float64) - b64
        return float(r @ r + lam * np.abs(np.asarray(x, np.float64)).sum())

    x0 = torch.zeros((10000,), dtype=prob.A.dtype, device=prob.A.device)
    rows = []
    for restart in (False, True):
        res, wall = _timed(
            lambda: prob.solve_fixed_step(
                x0, lr=lr, tol=tol, max_iter=20000, check_every=128,
                adaptive_restart=restart,
            ),
            repeats,
        )
        rows.append(
            dict(problem="lasso_n10k", restart=restart, nit=int(res.nit),
                 wall_s=round(wall, 4), F=F_host(res.x), status=int(res.status))
        )
    return rows


def bench_tv_deblur(repeats: int, tol: float = 1e-6, device: Any = "cuda") -> list[dict]:
    """TV deblurring 256^2 (BASELINE configs[1] workload), float32,
    inexact prox (30 FGP iterations per prox call)."""
    from zfista_tpu_torch.models.deblur import TVDeblur, gaussian_kernel, make_blur

    dev = data_device(device)
    rng = np.random.default_rng(0)
    size = 256
    img = np.zeros((size, size), np.float32)
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
    img[size // 2 :, : size // 2] = 0.5
    kernel = gaussian_kernel(9, 2.0)
    observed = make_blur(kernel)(torch.tensor(img, device=dev))
    observed = observed + torch.tensor(
        0.01 * rng.standard_normal(observed.shape).astype(np.float32), device=dev
    )
    prob = TVDeblur(observed, tv_ratio=1e-3, kernel=kernel, prox_iter=30)
    rows = []
    for restart in (False, True):
        res, wall = _timed(
            lambda: prob.solve(
                max_iter=2000, tol=tol, check_every=64,
                adaptive_restart=restart,
            ),
            repeats,
        )
        F = float(np.ravel(np.asarray(res.fun))[0])
        rows.append(
            dict(problem="tv_deblur_256", restart=restart, nit=int(res.nit),
                 wall_s=round(wall, 4), F=F, status=int(res.status))
        )
    return rows


def bench_tridia_batch(repeats: int, n_lanes: int = 256,
                       tol: float = 1e-6, device: Any = "cuda") -> list[dict]:
    """TRIDIA (m=n=3, ill-conditioned chain) batch, float32: mean/max nit
    across random starts through the public batch API."""
    from zfista_tpu_torch.models.zoo import TRIDIA
    from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch

    prob = TRIDIA()
    rng = np.random.default_rng(42)
    X0 = rng.uniform(-1.0, 1.0, size=(n_lanes, prob.n_features)).astype(
        np.float32
    )
    rows = []
    for restart in (False, True):
        res, wall = _timed(
            lambda: minimize_proximal_gradient_batch(
                prob.f, prob.g, prob.jac_f, prob.prox_wsum_g, X0,
                nesterov=True, tol=tol, max_iter=10000, check_every=64,
                adaptive_restart=restart, device=device,
            ),
            repeats,
        )
        nit = np.asarray(res.nit)
        rows.append(
            dict(problem=f"tridia_batch{n_lanes}", restart=restart,
                 nit=float(nit.mean()), nit_max=int(nit.max()),
                 wall_s=round(wall, 4),
                 n_converged=int(np.asarray(res.success).sum()))
        )
    return rows


def main(argv: Sequence[str] | None = None) -> None:
    """Print one JSON row per (problem, restart) and a paired summary."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--skip", default="", help="comma list: lasso,tv,tridia")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    dev = data_device(args.device)

    print(f"backend: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    rows = []
    if "lasso" not in skip:
        rows += bench_lasso(args.repeats, device=dev)
    if "tv" not in skip:
        rows += bench_tv_deblur(args.repeats, device=dev)
    if "tridia" not in skip:
        rows += bench_tridia_batch(args.repeats, device=dev)
    for r in rows:
        print(json.dumps(r))
    # paired speedup summary
    by = {}
    for r in rows:
        by.setdefault(r["problem"], {})[r["restart"]] = r
    for name, pair in by.items():
        if True in pair and False in pair:
            off, on = pair[False], pair[True]
            print(
                f"{name}: nit {off['nit']:.0f} -> {on['nit']:.0f} "
                f"({off['nit'] / max(on['nit'], 1):.2f}x), "
                f"wall {off['wall_s']:.3f}s -> {on['wall_s']:.3f}s "
                f"({off['wall_s'] / max(on['wall_s'], 1e-12):.2f}x)"
            )


if __name__ == "__main__":
    main()
