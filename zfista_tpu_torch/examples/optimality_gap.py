r"""North-star metric: wall time to an optimality gap on LASSO (n=10k).

Counterpart of the JAX package's ``examples/optimality_gap.py``.  For each
iteration target ``k``, times ``k`` float32 fixed-step FISTA steps from the
cold start, launched back to back and ended by one synchronization (the
least of 3 after a warm-up): the raw dense step
(:func:`~zfista_tpu_torch.ops.fused.fista_step_dense_fused`: two cuBLAS
matvecs and the fused kernel's ``fista_tail`` on a card, its plain version
on the CPU) and the public ``Lasso.solve_fixed_step`` (``check_every=64``;
the fused ``lasso_step_tail`` on a card).  Each checkpoint's objective is
evaluated in float64 on the host against ``F*`` from a float64 refinement
on the CPU (FISTA warm-started from the float32 solution).  Prints one
JSON object: the gaps and walls per target and the wall to a 1e-6 and a
1e-8 gap for both paths.

Usage:
    python -m zfista_tpu_torch.examples.optimality_gap [--n 10000] [--m 2000]
        [--lam 0.01] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from typing import Sequence

import numpy as np
import torch


def main(argv: Sequence[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=10_000)
    parser.add_argument("--m", type=int, default=2_000)
    parser.add_argument("--lam", type=float, default=0.01)
    parser.add_argument("--refine-iters", type=int, default=500)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from zfista_tpu_torch.core.solver import data_device
    from zfista_tpu_torch.models.lasso import Lasso, fista_step_dense, operator_norm_sq
    from zfista_tpu_torch.ops.fused import fista_step_dense_fused

    dev = data_device(args.device)
    m, n, lam = args.m, args.n, args.lam
    rng = np.random.default_rng(0)
    A64 = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, n // 100, replace=False)] = rng.standard_normal(n // 100)
    b64 = A64 @ x_true + 0.01 * rng.standard_normal(m)

    def F_host(x):
        r = A64 @ x - b64
        return float(r @ r + lam * np.abs(x).sum())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    A = torch.tensor(A64, dtype=torch.float32, device=dev)
    b = torch.tensor(b64, dtype=torch.float32, device=dev)
    L = float(2 * operator_norm_sq(A, 100))
    lr32 = torch.tensor(1.0 / L, dtype=torch.float32, device=dev)
    lam32 = torch.tensor(lam, dtype=torch.float32, device=dev)
    x0 = torch.zeros(n, dtype=torch.float32, device=dev)

    def run32(k):
        c = (x0, x0, torch.tensor(1.0, dtype=torch.float32, device=dev))
        for _ in range(k):
            c = fista_step_dense_fused(A, b, lam32, lr32, c)
        sync()
        return c

    def best_of(fn, k, reps=3):
        fn(k)  # warm-up
        best, out = np.inf, None
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            out = fn(k)
            best = min(best, time.perf_counter() - t0)
        return best, out

    targets = [250, 500, 1000, 2000, 4000]
    checkpoints = []
    for k in targets:
        wall, c = best_of(run32, k)
        checkpoints.append((k, wall, c[0].cpu().numpy().astype(np.float64)))

    # The public path users call.
    prob = Lasso(A, b, l1_ratio=lam)

    def public(k):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # status 0 at max_iter is the point
            return prob.solve_fixed_step(x0, lr=1.0 / L, tol=0.0, check_every=64, max_iter=k)

    pub_checkpoints = []
    for k in targets:
        wall, res = best_of(public, k)
        pub_checkpoints.append((k, wall, np.asarray(res.x, np.float64)))

    # Certified F*: float64 refinement on the CPU from the float32 solution.
    A6, b6 = torch.tensor(A64), torch.tensor(b64)
    lr64, lam64 = torch.tensor(1.0 / L, dtype=torch.float64), torch.tensor(lam, dtype=torch.float64)
    xw = torch.tensor(checkpoints[-1][2])
    c6 = (xw, xw, torch.tensor(1.0, dtype=torch.float64))
    for _ in range(args.refine_iters):
        c6 = fista_step_dense(A6, b6, lam64, lr64, c6)
    Fstar = F_host(c6[0].numpy())

    def pack(cps):
        return [{"iters": it, "wall_s": w, "gap": F_host(x) - Fstar} for it, w, x in cps]

    out = {
        "metric": "lasso_n10k_wall_to_gap",
        "device": str(dev),
        "F_star": Fstar,
        "checkpoints": pack(checkpoints),
        "public_checkpoints": pack(pub_checkpoints),
    }
    for key, cps in (("", out["checkpoints"]), ("public_", out["public_checkpoints"])):
        for thresh in [1e-6, 1e-8]:
            hit = next((cp for cp in cps if cp["gap"] <= thresh), None)
            out[f"{key}wall_to_{thresh:g}_gap_s"] = None if hit is None else hit["wall_s"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
