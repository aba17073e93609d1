"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's two slices on the card and checks every CUDA kernel of
them against its plain PyTorch version:

* dense LASSO (m=2000, n=10,000, float32, lambda=0.01, the recipe of
  bench.py) solved by fixed-step FISTA through
  ``zfista_tpu_torch.models.Lasso.solve_fixed_step`` (phases 2-5);
* TV-regularized deblurring (``examples/tv_deblur.py``'s workload: the
  synthetic cameraman at 256x256, Gaussian 9x9 sigma=4, noise 1e-3,
  tv_ratio 2e-4) through ``zfista_tpu_torch.models.TVDeblur``, whose TV
  prox runs the FGP kernels (phases 6-8).

Phases:

1. the card (``nvidia-smi``) and the kernels' build from ``csrc/``, one
   ``nvcc`` per source, all started together;
2. the fused prox-momentum kernel against its plain version, several sizes;
3. one dense FISTA step, fused against plain, at the full problem size;
4. the LASSO slice through the public entry point: launch counts,
   agreement with a float64 numpy FISTA loop, convergence, and
   ``check_every`` chunking bitwise equal to per-step checking;
5. the card's own times of the LASSO slice and of its kernel;
6. the three FGP kernels against the plain loop, bitwise, from 24x40 to
   2048x2048, both discretizations, cold and warm duals; serial and
   pipelined tiles bitwise equal; the dual-gap certificate;
7. the TV slice through the public entry points: a 500-iteration
   ``TVDeblur.solve`` (launch counts), agreement with a float64 plain-loop
   solve, PSNR, ``check_every`` bitwise, and ``solve_warm`` at 256x256 and
   at 2048x2048 on tv_bench's scene;
8. the card's own times: each FGP kernel and the plain loop per prox call
   from 256x256 to 2048x2048, and the TV solves' wall time, kernel
   against plain.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is not 0.  Without a CUDA device it exits at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial

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
SOURCES = ("fused_prox_momentum", "fgp_resident", "fgp_tiles")
#: Phase 6: images on which every FGP kernel is held against the plain loop.
TV_CHECK_CASES = (
    ((24, 40), torch.float32),
    ((100, 224), torch.float32),
    ((256, 256), torch.float32),
    ((768, 768), torch.float32),
    ((1024, 1024), torch.float32),
    ((2048, 2048), torch.float32),
    ((100, 224), torch.float64),
)
#: Phase 7: the cameraman's side, and tv_bench's scene sizes for solve_warm.
CAMERAMAN, TV_BENCH_SIZES = 256, (2048, 768)
#: Phase 8: image sides at which each prox call is timed.
TV_TIME_SIZES = (256, 384, 512, 768, 1024, 2048)
#: The FGP kernels: their source, and the TPU kernel body each replaces.
TV_KERNELS = {
    "fgp_resident": (
        "zfista_tpu_torch/csrc/fgp_resident.cu",
        "zfista_tpu/ops/tv_pallas.py:149",
    ),
    "fgp_tiles": (
        "zfista_tpu_torch/csrc/fgp_tiles.cu",
        "zfista_tpu/ops/tv_pallas.py:208",
    ),
    "fgp_tiles_pipelined": (
        "zfista_tpu_torch/csrc/fgp_tiles.cu",
        "zfista_tpu/ops/tv_pallas.py:301",
    ),
}


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


def psnr(x: np.ndarray, truth: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB against a truth image with peak 1."""
    mse = float(np.mean((np.reshape(x, truth.shape) - truth) ** 2))
    return float(10 * np.log10(1.0 / mse))


def tv_kernel_fns() -> dict:
    from zfista_tpu_torch.ops import tv_cuda

    return {
        "fgp_resident": tv_cuda.fgp_resident,
        "fgp_tiles": partial(tv_cuda.fgp_tiles, pipelined=False),
        "fgp_tiles_pipelined": partial(tv_cuda.fgp_tiles, pipelined=True),
    }


def quiet(fn, *args, **kwargs):
    """Run a solve whose max_iter cap is the point (status 0 warns)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


def phase6(dev) -> dict[str, float]:
    """The FGP kernels against the plain loop on the card.  Stated
    tolerance: 0.  The kernels are built with -fmad=false and compute the
    plain loop's operations in its order with correctly rounded sqrt and
    division, so they are bitwise equal to it; any difference is a fault."""
    from zfista_tpu_torch.ops import tv, tv_cuda

    kernels = tv_kernel_fns()
    counts = tv_cuda.launch_counts
    rng = np.random.default_rng(6)
    max_err = dict.fromkeys(kernels, 0.0)
    for shape, dtype in TV_CHECK_CASES:
        v = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
        near = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
        lam = torch.tensor(0.15, dtype=dtype, device=dev)
        z = torch.zeros_like(v)
        # A warm dual: the plain loop's feasible iterate for a nearby input.
        _, pw, qw = tv_cuda.fgp_plain(lam, v + 0.1 * near, z, z, 10)
        err = dict.fromkeys(kernels, 0.0)
        launched = dict.fromkeys(kernels, 0)
        calls = sweeps = 0
        for iso in (True, False):
            for n_iter in (30, 8):
                for dual in ((z, z), (pw, qw)):
                    ref = tv_cuda.fgp_plain(lam, v, *dual, n_iter, iso)
                    outs = {}
                    for name, fn in kernels.items():
                        before = counts[name]
                        outs[name] = fn(lam, v, *dual, n_iter, iso)
                        launched[name] += counts[name] - before
                    torch.cuda.synchronize()
                    for name, out in outs.items():
                        e = max(float(torch.max(torch.abs(a - b))) for a, b in zip(out, ref))
                        err[name] = max(err[name], e)
                    pair = zip(outs["fgp_tiles"], outs["fgp_tiles_pipelined"])
                    if not all(torch.equal(a, b) for a, b in pair):
                        raise AssertionError(
                            f"fgp_tiles and fgp_tiles_pipelined differ at {shape}"
                        )
                    calls += 1
                    sweeps += -(-n_iter // tv_cuda.HALO) + 1  # sweeps + u pass
        want = {"fgp_resident": calls, "fgp_tiles": sweeps, "fgp_tiles_pipelined": sweeps}
        log(
            f"phase 6: {shape[0]}x{shape[1]} {str(dtype)[6:]}: max_abs_err {err} "
            "(tolerance 0, bitwise; iso/aniso, n_iter 30 and 8, zero and warm "
            "duals); fgp_tiles == fgp_tiles_pipelined bitwise; "
            f"launches {launched}"
        )
        if any(e != 0.0 for e in err.values()) or launched != want:
            raise AssertionError(f"FGP kernels vs plain at {shape}: {err}, {launched}")
        for name in kernels:
            max_err[name] = max(max_err[name], err[name])
        if shape == (CAMERAMAN, CAMERAMAN):
            gaps = {}
            for name, fn in [("fgp_plain", tv_cuda.fgp_plain), *kernels.items()]:
                u, p, q = fn(lam, v, z, z, 30, True)
                gaps[name] = float(tv.tv_dual_gap(lam, v, u, (p, q)))
            log(f"phase 6: tv_dual_gap at {shape[0]}x{shape[1]}, n_iter 30: {gaps}")
            if len(set(gaps.values())) != 1 or not gaps["fgp_plain"] >= 0:
                raise AssertionError(f"dual-gap certificates differ: {gaps}")
    return max_err


def tv_bench_scene(size: int, dev) -> tuple[np.ndarray, np.ndarray]:
    """zfista_tpu/bench/tv_bench.py's nested-deblur scene: two flat blocks,
    Gaussian 9x9 sigma=2, noise 0.01 (numpy seed 0).  Returns the kernel
    and the observation (blurred in float64 on the card)."""
    from zfista_tpu_torch.models import deblur as td

    img = np.zeros((size, size))
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
    img[size // 2 :, : size // 2] = 0.5
    kernel = td.gaussian_kernel(9, 2.0)
    observed = td.make_blur(kernel)(torch.tensor(img, device=dev)).cpu().numpy()
    observed += 0.01 * np.random.default_rng(0).standard_normal(observed.shape)
    return kernel, observed


def zero(counts: dict[str, int]) -> None:
    for name in counts:
        counts[name] = 0


def phase7(dev) -> tuple[dict[str, int], dict[str, int]]:
    """The TV slice through the public entry points.  Each FGP kernel's
    main-path run is the first run below that ``auto`` sends to it: the
    500-iteration ``solve`` (the whole-image kernel at 256x256) and the
    ``solve_warm`` runs on tv_bench's scene (the tile kernels).  Every
    count is set to 0 just before each run and read just after.  Returns
    each kernel's launches in its main-path run, and that run's image
    side."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.models import deblur as td
    from zfista_tpu_torch.ops import tv_cuda

    counts = tv_cuda.launch_counts
    truth_t = td.synthetic_cameraman(CAMERAMAN, dtype=torch.float64)
    truth = truth_t.numpy()
    observed = td.make_blur(td.gaussian_kernel())(truth_t).numpy()
    observed = observed + 1e-3 * np.random.default_rng(0).standard_normal(observed.shape)
    b32 = torch.tensor(observed, dtype=torch.float32, device=dev)
    b64 = torch.tensor(observed, dtype=torch.float64, device=dev)
    kw = dict(tv_ratio=2e-4, prox_iter=30)
    kinds = {
        "cuda_resident": "fgp_resident",
        "cuda_tiles": "fgp_tiles",
        "cuda_tiles_pipelined": "fgp_tiles_pipelined",
    }

    prob = TVDeblur(b32, **kw)
    meta = prob.checkpoint_meta()
    zero(counts)  # the main-path solve starts here
    t0 = time.perf_counter()
    res = quiet(prob.solve, max_iter=500, tol=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(counts)  # ... and ends here
    log(
        f"phase 7: TVDeblur(cameraman {CAMERAMAN}x{CAMERAMAN} f32, tv_ratio 2e-4, "
        "prox_iter 30)"
        f".solve(max_iter=500, tol=0): nit={res.nit} status={res.status} "
        f"fun={float(np.ravel(res.fun)[0])!r} lr={res.lr!r} wall {wall:.3f} s; "
        f"prox_kernel {meta['prox_kernel']}; kernel launches {launched}"
    )
    if res.nit != 500 or res.x.shape != (CAMERAMAN**2,) or not np.all(np.isfinite(res.x)):
        raise AssertionError("TV slice run: wrong nit or non-finite x")
    kern = kinds[meta["prox_kernel"]]
    if launched[kern] < 500:
        raise AssertionError(f"TV slice run launched the kernels {launched}")
    main_launches, runs = {kern: launched[kern]}, {kern: CAMERAMAN}
    lr = res.lr

    short = quiet(TVDeblur(b32, **kw).solve, lr=lr, max_iter=AGREE_ITERS, tol=0)
    plain = quiet(
        TVDeblur(b32, prox_method="xla", **kw).solve, lr=lr, max_iter=AGREE_ITERS, tol=0
    )
    ref = quiet(
        TVDeblur(b64, prox_method="xla", **kw).solve, lr=lr, max_iter=AGREE_ITERS, tol=0
    )
    rel = float(np.linalg.norm(short.x - ref.x) / np.linalg.norm(ref.x))
    log(
        f"phase 7: first {AGREE_ITERS} iterations vs the float64 plain-prox solve "
        f"on the card: relative 2-norm diff {rel!r} (bound {AGREE_RTOL}); "
        f"float32 kernel solve == float32 plain-prox solve bitwise: "
        f"{np.array_equal(short.x, plain.x)}"
    )
    log(
        f"phase 7: PSNR vs truth: observed {psnr(observed, truth):.3f} dB, "
        f"f32 kernel 500 it {psnr(res.x, truth):.3f} dB, f32 kernel "
        f"{AGREE_ITERS} it {psnr(short.x, truth):.3f} dB, f64 plain "
        f"{AGREE_ITERS} it {psnr(ref.x, truth):.3f} dB"
    )
    if not rel <= AGREE_RTOL:
        raise AssertionError("TV slice disagrees with the float64 plain-prox solve")
    if not np.array_equal(short.x, plain.x):
        raise AssertionError("TV slice: kernel and plain-prox solves differ")

    conv = {}
    for ce in (1, 64):
        t0 = time.perf_counter()
        conv[ce] = quiet(TVDeblur(b32, **kw).solve, lr=lr, check_every=ce, max_iter=3000)
        log(
            f"phase 7: default-tol solve, check_every={ce}: status={conv[ce].status} "
            f"nit={conv[ce].nit} err={conv[ce].error_criterion!r} "
            f"wall {time.perf_counter() - t0:.3f} s"
        )
    for name, a, c in zip(conv[1].state._fields, conv[1].state, conv[64].state):
        if not np.array_equal(a, c):
            raise AssertionError(f"check_every=64 differs from 1 in State.{name}")
    log("phase 7: check_every=64 is bitwise equal to check_every=1 (x, nit, State)")

    scenes = [(CAMERAMAN, td.gaussian_kernel(), observed, 2e-4)]
    scenes += [(n, *tv_bench_scene(n, dev), 1e-3) for n in TV_BENCH_SIZES]
    for size, kernel, obs, tv_ratio in scenes:
        b = torch.tensor(obs, dtype=torch.float32, device=dev)
        prob = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel)
        kind = prob.checkpoint_meta()["prox_kernel"]
        zero(counts)
        t0 = time.perf_counter()
        w = prob.solve_warm(max_iter=200, tol=0, prox_iter=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(counts)
        wp = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method="xla").solve_warm(
            max_iter=200, tol=0, prox_iter=8
        )
        same = np.array_equal(w["x"], wp["x"])
        log(
            f"phase 7: solve_warm(max_iter=200, prox_iter=8) at {size}x{size} f32: "
            f"auto picks {kind}; nit={w['nit']} fun={w['fun']!r} wall {wall:.3f} s; "
            f"launches {used}; == plain-prox solve_warm bitwise: {same}"
        )
        if w["nit"] != 200 or not np.all(np.isfinite(w["x"])) or not same:
            raise AssertionError(f"solve_warm at {size}: wrong nit, non-finite or != plain")
        if used[kinds[kind]] < 200:
            raise AssertionError(f"solve_warm at {size} launched {used}")
        if kinds[kind] not in runs:
            main_launches[kinds[kind]] = used[kinds[kind]]
            runs[kinds[kind]] = size

    for name in TV_KERNELS:
        if not main_launches.get(name):
            raise AssertionError(f"the TV slice never launched {name}")
    log(f"phase 7: main-path launches {main_launches} at image sides {runs}")
    return main_launches, runs


def chain_ms(fn, v0, lam, calls: int = 20) -> float:
    """Device ms per prox call over ``calls`` chained calls (each call's u
    is the next call's v), by CUDA events, after one warm-up call."""
    z = torch.zeros_like(v0)
    fn(lam, v0, z, z, 30)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    v = v0
    for _ in range(calls):
        v = fn(lam, v, z, z, 30)[0]
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def phase8(dev) -> dict[int, dict[str, float]]:
    """The card's times of the TV slice.  Returns ms per prox call
    (n_iter=30) by image size and implementation."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.models import deblur as td
    from zfista_tpu_torch.ops import tv_cuda

    fns = {"fgp_plain": tv_cuda.fgp_plain, **tv_kernel_fns()}
    rng = np.random.default_rng(8)
    lam = torch.tensor(0.05, device=dev)
    ms: dict[int, dict[str, float]] = {}
    for n in TV_TIME_SIZES:
        v0 = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
        runs: dict[str, list[float]] = {k: [] for k in fns}
        for order in (list(fns), list(reversed(fns))):
            for k in order:
                runs[k].append(chain_ms(fns[k], v0, lam))
        ms[n] = {k: min(v) for k, v in runs.items()}
        log(
            f"phase 8: prox call {n}x{n} f32 n_iter=30, ms per call (20 chained "
            f"calls, CUDA events, runs {{k: [..]}}): "
            + ", ".join(f"{k} {min(v):.4f} {[round(x, 4) for x in v]}" for k, v in runs.items())
        )

    truth_t = td.synthetic_cameraman(CAMERAMAN, dtype=torch.float64)
    observed = td.make_blur(td.gaussian_kernel())(truth_t).numpy()
    observed = observed + 1e-3 * np.random.default_rng(0).standard_normal(observed.shape)
    b32 = torch.tensor(observed, dtype=torch.float32, device=dev)
    solves = {
        "solve 500 it": lambda m: quiet(
            TVDeblur(b32, tv_ratio=2e-4, prox_iter=30, prox_method=m).solve,
            max_iter=500, tol=0,
        ),
        "solve_warm 200 it": lambda m: TVDeblur(
            b32, tv_ratio=2e-4, prox_method=m
        ).solve_warm(max_iter=200, tol=0, prox_iter=8),
    }
    for what, run in solves.items():
        walls: dict[str, list[float]] = {"auto": [], "xla": []}
        for m in ("auto", "xla", "xla", "auto"):
            walls[m].append(sync_time(lambda: run(m)))
        log(
            f"phase 8: TVDeblur {what} at {CAMERAMAN}x{CAMERAMAN} f32 wall s: kernel "
            f"{[round(x, 4) for x in walls['auto']]}, plain prox "
            f"{[round(x, 4) for x in walls['xla']]}"
        )
    return ms


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
    # set: full-fp32 cuBLAS products and cuDNN convolutions, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi!r}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(
        f"phase 1: built {[p.name for p in paths]} in "
        f"{time.perf_counter() - t0:.3f} s (in parallel)"
    )

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

    tv_err = phase6(dev)
    tv_launches, tv_runs = phase7(dev)
    tv_ms = phase8(dev)

    kernels = [
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
    for name, (source, replaces) in TV_KERNELS.items():
        # Each kernel's time at the size its main-path run used.
        n = tv_runs[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": tv_launches[name],
                "max_abs_err": tv_err[name],
                "ms": tv_ms[n][name],
                "plain_ms": tv_ms[n]["fgp_plain"],
            }
        )
    print(json.dumps({"kernels": kernels}))
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
