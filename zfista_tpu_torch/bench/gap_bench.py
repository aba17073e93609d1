"""Wall-time to optimality gap on the headline LASSO (north-star clause 2).

PyTorch-port counterpart of :mod:`zfista_tpu.bench.gap_bench`, with its
names and signatures plus ``device`` and ``dtype``.  For each gap target
it finds the smallest iteration count ``N*`` (at chunk granularity) whose
float64 optimality gap ``F(x_N) - F*`` meets the target, then times ``N*``
iterations with no host synchronization inside the measured window, for
both the raw dense step and the public ``Lasso.solve_fixed_step``.

Numerics: the stopping decision and ``F*`` are evaluated on the HOST in
float64 (the float32 objective on the device carries ~1e-7-relative noise,
which would make a 1e-8 absolute gap test meaningless).  ``F*`` is the
minimum host-f64 objective along a reference run 3x the probe budget.

Raw step: a "chunk" is ``chunk`` steps launched back to back, each step
:func:`zfista_tpu_torch.ops.fused.fista_step_dense_fused` on a card (two
cuBLAS GEMVs and the fused kernel's ``fista_tail``) and the plain
:func:`zfista_tpu_torch.models.lasso.fista_step_dense` on the CPU.  A
timed window launches its chunks from a fresh carry and ends in one
``torch.cuda.synchronize()``.  The public pass times
``Lasso.solve_fixed_step`` (on a card the fused kernel's
``lasso_step_tail``, one launch per step), which returns host values.

Usage::

    python -m zfista_tpu_torch.bench.gap_bench             # n=10k headline
    python -m zfista_tpu_torch.bench.gap_bench --targets 1e-6,1e-8 --repeats 5

``--unroll`` is the JAX CLI's loop-unroll depth; eager PyTorch has no
counterpart, so it is accepted and ignored, and both CLIs take the same
flags.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Sequence

import numpy as np
import torch


def make_problem(m: int, n: int, seed: int = 0):
    """The bench.py headline problem: dense Gaussian A, 100-sparse truth."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m)
    x_true = np.zeros(n, np.float32)
    idx = rng.choice(n, min(100, n // 2), replace=False)
    x_true[idx] = rng.standard_normal(len(idx)).astype(np.float32)
    b = A @ x_true + 0.01 * rng.standard_normal(m).astype(np.float32)
    return A, b, 0.01


def lipschitz_np(A: np.ndarray, n_iter: int = 100) -> float:
    """2 * ||A||_2^2 by float64 power iteration (host; exact enough that
    lr = 1/L is a valid fixed step)."""
    A64 = np.asarray(A, np.float64)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(A64.shape[1])
    v /= np.linalg.norm(v)
    for _ in range(n_iter):
        w = A64.T @ (A64 @ v)
        v = w / np.linalg.norm(w)
    return 2.0 * float(v @ (A64.T @ (A64 @ v)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(
    m: int = 2000,
    n: int = 10000,
    targets: Sequence[float] = (1e-6, 1e-8),
    chunk: int = 256,
    unroll: int = 64,
    repeats: int = 3,
    max_chunks: int = 64,
    device: Any = "cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Measure wall-to-gap on ``device`` (default ``"cuda"``; a machine
    with no card raises) in ``dtype`` (float32, the headline's; the JAX
    module follows its x64 switch instead); returns the result record.
    ``unroll`` is accepted for the JAX signature and ignored."""
    if repeats < 1 or chunk < 1 or max_chunks < 1:
        raise ValueError(
            f"repeats/chunk/max_chunks must be >= 1; got "
            f"{repeats}/{chunk}/{max_chunks}"
        )
    from zfista_tpu_torch.core.solver import data_device
    from zfista_tpu_torch.models.lasso import Lasso, fista_step_dense
    from zfista_tpu_torch.ops.fused import fista_step_dense_fused

    dev = data_device(device)
    A_np, b_np, lam = make_problem(m, n)
    lr = 1.0 / lipschitz_np(A_np)

    A64 = np.asarray(A_np, np.float64)
    b64 = np.asarray(b_np, np.float64)

    def F_host(x) -> float:
        x = np.asarray(x.detach().cpu().numpy(), np.float64)
        r = A64 @ x - b64
        return float(r @ r + lam * np.abs(x).sum())

    A = torch.tensor(A_np, dtype=dtype, device=dev)
    b = torch.tensor(b_np, dtype=dtype, device=dev)
    lam_dev = torch.tensor(lam, dtype=dtype, device=dev)
    lr_dev = torch.tensor(lr, dtype=dtype, device=dev)
    step = fista_step_dense_fused if dev.type == "cuda" else fista_step_dense

    def run_chunk(carry):
        for _ in range(chunk):
            carry = step(A, b, lam_dev, lr_dev, carry)
        return carry

    def fresh_carry():
        x0 = torch.zeros((n,), dtype=dtype, device=dev)
        return (x0, x0, torch.tensor(1.0, dtype=dtype, device=dev))

    # --- reference run: F* = min host-f64 objective over 3x the budget
    # (evaluated at periodic checkpoints: FISTA is non-monotone, and at the
    # f32 floor the last iterate is not guaranteed minimal) ---
    carry = fresh_carry()
    F_star = np.inf
    for i in range(3 * max_chunks):
        carry = run_chunk(carry)
        if (i + 1) % 16 == 0 or i + 1 == 3 * max_chunks:
            F_star = min(F_star, F_host(carry[0]))

    # --- probe pass: first chunk count k meeting each target ---
    targets = sorted(float(t) for t in targets)  # tightest last
    k_for: dict[float, int | None] = {t: None for t in targets}
    gaps = []
    carry = fresh_carry()
    for k in range(1, max_chunks + 1):
        carry = run_chunk(carry)
        gap = F_host(carry[0]) - F_star
        gaps.append(gap)
        for t in targets:
            if k_for[t] is None and gap <= t:
                k_for[t] = k
        if all(v is not None for v in k_for.values()):
            break

    # --- timed passes ---
    def time_raw(k: int) -> float:
        best = np.inf
        for _ in range(repeats):
            c = fresh_carry()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(k):
                c = run_chunk(c)
            _sync(dev)  # the window's one synchronization
            best = min(best, time.perf_counter() - t0)
        return best

    prob = Lasso(A, b, lam)
    x0 = torch.zeros((n,), dtype=dtype, device=dev)

    def time_public(k: int) -> float:
        opts = dict(lr=lr, tol=0.0, check_every=min(128, chunk))
        prob.solve_fixed_step(x0, max_iter=k * chunk, **opts)  # warm-up
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = prob.solve_fixed_step(x0, max_iter=k * chunk, **opts)
            best = min(best, time.perf_counter() - t0)
        if res.nit != k * chunk:
            raise RuntimeError(f"public solve ran {res.nit} of {k * chunk} steps")
        return best

    rows = []
    for t in targets:
        k = k_for[t]
        if k is None:
            rows.append(
                dict(target=t, iterations=None, raw_s=None, public_s=None,
                     note=f"not reached in {max_chunks * chunk} iterations "
                          f"(last gap {gaps[-1]:.3e})")
            )
            continue
        rows.append(
            dict(
                target=t,
                iterations=k * chunk,
                raw_s=round(time_raw(k), 4),
                public_s=round(time_public(k), 4),
            )
        )

    return dict(
        metric="lasso_wall_to_gap",
        m=m,
        n=n,
        lam=lam,
        chunk=chunk,
        backend=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        F_star=F_star,
        rows=rows,
    )


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=2000)
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--targets", type=str, default="1e-6,1e-8")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--unroll", type=int, default=64, help="ignored (no eager counterpart)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--max-chunks", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = p.parse_args(argv)
    record = run(
        m=args.m,
        n=args.n,
        targets=[float(t) for t in args.targets.split(",")],
        chunk=args.chunk,
        unroll=args.unroll,
        repeats=args.repeats,
        max_chunks=args.max_chunks,
        device=args.device,
        dtype=getattr(torch, args.dtype),
    )
    print(json.dumps(record))


if __name__ == "__main__":
    main()
