r"""Momentum-pair (a, b) sweep across the multiobjective problem suite.

Counterpart of the JAX package's ``examples/momentum_experiment.py`` (the
reference's examples/PGM_experiment_with_various_a_b.ipynb): for JOS1
(n=50), JOS1+L1, SD, FDS (n=10) and FDS constrained, run many random
starts for each of the 15 momentum pairs and write ``{problem}_ab.csv``
rows ``a ,b,time,nit`` (mean over converged starts) under ``--out``.  The
whole grid x starts product per problem is one lane-batched solve, float64.

Usage:
    python -m zfista_tpu_torch.examples.momentum_experiment [--n-starts 1000]
        [--out bench_results/torch] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Sequence

import numpy as np


def main(argv: Sequence[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-starts", type=int, default=1000)
    parser.add_argument("--out", type=Path, default=Path("bench_results/torch"))
    parser.add_argument("--max-iter", type=int, default=10_000)
    parser.add_argument("--lane-chunk", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from zfista_tpu_torch.bench.momentum_sweep import momentum_sweep, write_ab_csv
    from zfista_tpu_torch.models.zoo import FDS, JOS1, SD

    suite = [
        ("JOS1", JOS1(n_features=50), -2, 4),
        (
            "JOS1_L1",
            JOS1(n_features=50, l1_ratios=[1 / 50, 2 / 50], l1_shifts=[0, -1]),
            -2,
            4,
        ),
        ("SD", SD(), 1, 2),
        ("FDS", FDS(n_features=10), -2, 2),
        ("FDS_CONSTRAINED", FDS(n_features=10, bounds=(0, np.inf)), 0, 2),
    ]
    for name, prob, low, high in suite:
        rows, _ = momentum_sweep(
            prob,
            low,
            high,
            n_starts=args.n_starts,
            max_iter=args.max_iter,
            lane_chunk=args.lane_chunk,
            device=args.device,
        )
        out = args.out / f"{name}_ab.csv"
        write_ab_csv(rows, out)
        # Pairs with no converged start carry nit=None: skip them here.
        ok_rows = [r for r in rows if r["nit"] is not None]
        if not ok_rows:
            print(f"{name}: no momentum pair converged for any start")
            continue
        best = min(ok_rows, key=lambda r: r["nit"])
        classic = rows[0]
        classic_s = f"{classic['nit']:.1f} it" if classic["nit"] is not None else "failed"
        print(
            f"{name}: classic (0,0) {classic_s} -> best "
            f"(a={best['a']}, b={best['b']}) {best['nit']:.1f} it"
        )


if __name__ == "__main__":
    main()
