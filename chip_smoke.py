"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path — dense LASSO (m=2000, n=10,000, float32,
lambda=0.01, the recipe of bench.py) solved by fixed-step FISTA through
``zfista_tpu_torch.models.Lasso.solve_fixed_step`` — on the card, and checks
every CUDA kernel of that path against its plain PyTorch version.  Phases:

1. the card (``nvidia-smi``) and the kernels' build from ``csrc/``;
2. each kernel against its plain version on the card, at several sizes;
3. one dense FISTA step, fused against plain, at the full problem size;
4. the slice through the public entry point: launch counts, agreement
   with a float64 numpy FISTA loop, convergence, and ``check_every``
   chunking bitwise equal to per-step checking;
5. the card's own times: iterations/s of the public path, of a raw loop
   of fused steps and of a raw loop of plain steps, and the kernel alone.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is not 0.  Without a CUDA device it exits at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

M, N, LAM = 2000, 10_000, 0.01
#: Bytes of HBM one FISTA iteration must read: A (80 MB in float32) twice,
#: once per matvec (it exceeds the 50 MB L2); the n-vectors add <1 MB.
BYTES_PER_ITER = 2 * M * N * 4
KERNEL_SOURCE = "zfista_tpu_torch/csrc/fused_prox_momentum.cu"
KERNEL_REPLACES = "zfista_tpu/ops/fused.py:62"
#: First iterations of the slice compared with the float64 numpy loop, and
#: the bound on their relative 2-norm difference: float32 rounding
#: (eps 6e-8) amplified over 200 momentum steps.
AGREE_ITERS, AGREE_RTOL = 200, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def make_problem():
    """bench.py's problem: numpy seed 0, A/sqrt(m), 100-sparse x_true."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((M, N)).astype(np.float32) / np.sqrt(M)).astype(
        np.float32
    )
    x_true = np.zeros(N, np.float32)
    idx = rng.choice(N, 100, replace=False)
    x_true[idx] = rng.standard_normal(100).astype(np.float32)
    b = (A @ x_true + 0.01 * rng.standard_normal(M).astype(np.float32)).astype(
        np.float32
    )
    return A, b


def numpy_fista(A, b, lam, lr, n_iter):
    """bench.py's float64 host FISTA loop (the reference's compute pattern)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    x = np.zeros(A.shape[1])
    y = x.copy()
    t = 1.0
    for _ in range(n_iter):
        grad = 2 * (A.T @ (A @ y - b))
        z = y - lr * grad
        x_new = np.sign(z) * np.maximum(np.abs(z) - lr * lam, 0)
        t_new = np.sqrt(t * t + 0.25) + 0.5
        y = x_new + ((t - 1) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def sync_time(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, by CUDA events over ``reps``."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False)"
        )

    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.ops import _build, fused

    dev = torch.device("cuda", 0)
    # The precision policy (zfista_tpu_torch/ops/precision.py), stated and
    # set: full-fp32 cuBLAS products, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi!r}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.build("fused_prox_momentum")
    _build.load("fused_prox_momentum")
    log(f"phase 1: built {lib_path.name} in {time.perf_counter() - t0:.3f} s")

    # -- phase 2: kernel vs plain on the card --------------------------------
    # Sizes: edge cases, the main path's n=10,000, and 10^7 (past the L2).
    # Stated tolerance: 0.  The kernel is built with -fmad=false and the
    # plain version computes in the same operation order, so they are
    # bitwise equal; any difference is a fault.
    rng = np.random.default_rng(1)
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in (1, 1000, N, 10_001, 10_000_000):
            y, g, x = (
                torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
                for _ in range(3)
            )
            scal = [torch.tensor(v, dtype=dtype, device=dev) for v in (0.1, 0.05, 0.3)]
            before = fused.launch_counts["fused_prox_momentum"]
            xk, yk = fused.fused_prox_momentum(y, g, x, *scal)
            launched = fused.launch_counts["fused_prox_momentum"] - before
            xp, yp = fused.fused_prox_momentum_plain(y, g, x, *scal)
            torch.cuda.synchronize()
            err = max(
                float(torch.max(torch.abs(xk - xp))),
                float(torch.max(torch.abs(yk - yp))),
            )
            max_err = max(max_err, err)
            log(
                f"phase 2: fused_prox_momentum {str(dtype)[6:]} n={n}: "
                f"max_abs_err={err!r} (tolerance 0, bitwise), launches +{launched}"
            )
            if err != 0.0 or launched != 1:
                raise AssertionError(
                    f"kernel vs plain: err {err!r}, launches {launched}"
                )
            del y, g, x, xk, yk, xp, yp

    # -- phase 3: the dense step at the full problem size --------------------
    A_np, b_np = make_problem()
    A = torch.as_tensor(A_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    prob = Lasso(A, b, LAM)
    L = prob.lipschitz()
    lr = torch.tensor(1.0 / L, dtype=torch.float32, device=dev)
    lam = torch.tensor(LAM, dtype=torch.float32, device=dev)
    zero = torch.zeros(N, dtype=torch.float32, device=dev)
    carry = (zero, zero, torch.tensor(1.0, device=dev))
    for _ in range(3):  # a carry with nonzero momentum
        carry = fista_step_dense(A, b, lam, lr, carry)
    ref = fista_step_dense(A, b, lam, lr, carry)
    got = fused.fista_step_dense_fused(A, b, lam, lr, carry)
    step_err = max(float(torch.max(torch.abs(r - g_))) for r, g_ in zip(ref, got))
    log(
        f"phase 3: fista_step_dense_fused vs fista_step_dense at m={M} n={N} "
        f"f32 (L={L!r}): max_abs_err={step_err!r} (tolerance 0, bitwise)"
    )
    if step_err != 0.0:
        raise AssertionError(f"dense step: fused differs from plain by {step_err!r}")

    # -- phase 4: the slice through the public entry point --------------------
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    fused.launch_counts["fused_prox_momentum"] = 0
    res = Lasso(A, b, LAM).solve_fixed_step(x0, tol=0, max_iter=4000)
    torch.cuda.synchronize()
    main_launches = fused.launch_counts["fused_prox_momentum"]
    log(
        f"phase 4: Lasso.solve_fixed_step(tol=0, max_iter=4000): nit={res.nit} "
        f"status={res.status} fun={float(res.fun[0])!r} lr={res.lr!r} "
        f"kernel launches={main_launches}"
    )
    if res.nit != 4000 or not np.all(np.isfinite(res.x)) or res.x.shape != (N,):
        raise AssertionError("slice run: wrong nit or non-finite x")
    if main_launches < 4000:
        raise AssertionError(f"slice run launched the kernel {main_launches} times")

    short = Lasso(A, b, LAM).solve_fixed_step(
        x0, lr=res.lr, tol=0, max_iter=AGREE_ITERS
    )
    x_np = numpy_fista(A_np, b_np, LAM, res.lr, AGREE_ITERS)
    rel = float(np.linalg.norm(short.x - x_np) / np.linalg.norm(x_np))
    log(
        f"phase 4: first {AGREE_ITERS} iterations vs float64 numpy FISTA: "
        f"relative 2-norm diff {rel!r} (bound {AGREE_RTOL})"
    )
    if not rel <= AGREE_RTOL:
        raise AssertionError("slice disagrees with the float64 numpy loop")

    conv = {}
    for ce in (None, 1, 64):
        t0 = time.perf_counter()
        conv[ce] = Lasso(A, b, LAM).solve_fixed_step(x0, lr=res.lr, check_every=ce)
        log(
            f"phase 4: default-tol solve, check_every={ce}: status={conv[ce].status} "
            f"nit={conv[ce].nit} err={conv[ce].error_criterion!r} "
            f"wall {time.perf_counter() - t0:.3f} s"
        )
        if conv[ce].status != 1:
            raise AssertionError(
                f"default-tol solve did not converge (check_every={ce})"
            )
    for ce in (None, 64):
        for name, a, c in zip(conv[1].state._fields, conv[1].state, conv[ce].state):
            if not np.array_equal(a, c):
                raise AssertionError(f"check_every={ce} differs from 1 in State.{name}")
    log(
        "phase 4: check_every=64 and auto are bitwise equal to check_every=1 "
        "(x, nit, State)"
    )

    # -- phase 5: the card's own times ----------------------------------------
    iters = 2000

    def public():
        Lasso(A, b, LAM).solve_fixed_step(x0, lr=res.lr, tol=0, max_iter=iters)

    def raw(step):
        def run():
            c = (x0, x0, torch.tensor(1.0, device=dev))
            for _ in range(iters):
                c = step(A, b, lam, lr, c)
        return run

    runs = {
        "public": public,
        "raw_fused": raw(fused.fista_step_dense_fused),
        "raw_plain": raw(fista_step_dense),
    }
    for fn in runs.values():  # warm-up: cuBLAS handles, allocator pools
        fn()
    rates: dict[str, list[float]] = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs)), list(runs)):
        for k in order:
            rates[k].append(iters / sync_time(runs[k]))
    for k, v in rates.items():
        med = statistics.median(v)
        log(
            f"phase 5: {k}: {med:.1f} iter/s median of {[round(r, 1) for r in v]}; "
            f"{med * BYTES_PER_ITER / 1e9:.1f} GB/s against "
            f"{BYTES_PER_ITER / 1e6:.0f} MB/iter"
        )

    kern_ms = {}
    for n in (N, 10_000_000):
        y, g, x = (torch.randn(n, device=dev) for _ in range(3))
        scal = [torch.tensor(v, device=dev) for v in (0.1, 0.05, 0.3)]
        reps = 2000 if n == N else 100
        k_ms = event_ms(lambda: fused.fused_prox_momentum(y, g, x, *scal), reps)
        p_ms = event_ms(lambda: fused.fused_prox_momentum_plain(y, g, x, *scal), reps)
        kern_ms[n] = (k_ms, p_ms)
        log(
            f"phase 5: fused_prox_momentum f32 n={n}: kernel {k_ms * 1e3:.2f} us "
            f"({20 * n / (k_ms * 1e-3) / 1e9:.1f} GB/s at 20 B/elem), "
            f"plain {p_ms * 1e3:.2f} us"
        )

    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "fused_prox_momentum",
                        "route": "cuda",
                        "source": KERNEL_SOURCE,
                        "replaces": KERNEL_REPLACES,
                        "launches": main_launches,
                        "max_abs_err": max(max_err, step_err),
                        "ms": kern_ms[N][0],
                        "plain_ms": kern_ms[N][1],
                    }
                ]
            }
        )
    )
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
