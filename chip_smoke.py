"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's three slices on the card and checks every CUDA kernel
of them against its plain PyTorch version:

* dense LASSO (m=2000, n=10,000, float32, lambda=0.01, the recipe of
  bench.py) solved by fixed-step FISTA through
  ``zfista_tpu_torch.models.Lasso.solve_fixed_step`` (phases 2-5);
* TV-regularized deblurring (``examples/tv_deblur.py``'s workload: the
  synthetic cameraman at 256x256, Gaussian 9x9 sigma=4, noise 1e-3,
  tv_ratio 2e-4) through ``zfista_tpu_torch.models.TVDeblur``, whose TV
  prox runs the FGP kernels (phases 6-8);
* the single solve with backtracking and several objectives (phases
  9-11): the LASSO above by ``Lasso.solve``, and the benchmark harness's
  15 zoo problems (``zfista_tpu/bench/harness.py``) through
  ``Problem.solve``;
* the batch solver (phase 12): the harness's problems as ``benchmark()``
  batches them through ``Problem.solve_batch``, the 1k-lambda elastic-net
  sweep through ``make_lasso_lambda_sweep``, and wide JOS1 and FDS
  batches.  Phases 9-12 add no CUDA kernel: cuBLAS products and small
  elementwise launches.

Phases:

1. the card (``nvidia-smi``) and the kernels' build from ``csrc/``, one
   ``nvcc`` per source, all started together;
2. the fused LASSO kernel's three entries (prox + momentum, the raw step's
   tail, the solver's step tail) against their plain versions, bitwise,
   float32 and float64, n from 1 to 10^7, on active, converging, stopped
   and NaN-carrying states;
3. one dense FISTA step, fused against plain, at the full problem size;
4. the LASSO slice through the public entry point: launch counts (the
   step tail once per step), agreement with a float64 numpy FISTA loop,
   the routed ``tol_rel`` solve bitwise equal to the fused tail's,
   convergence, and ``check_every`` chunking bitwise equal to per-step
   checking;
5. the card's own times of the LASSO slice and of its kernel's entries,
   and (run after phase 9) device events and busy time per iteration of
   the public path and the raw loops, by torch.profiler;
6. the three FGP kernels against the plain loop, bitwise, from 1x105 to
   2048x2048 (the tile windows' edges in float32 and float64; float64 at
   256x256 through the whole-image kernel and at 600x520), both
   discretizations, cold and warm duals; serial and pipelined tiles
   bitwise equal; the dual-gap certificate;
7. the TV slice through the public entry points: a 500-iteration
   ``TVDeblur.solve`` (launch counts), agreement with a float64 plain-loop
   solve, PSNR, ``check_every`` bitwise, and ``solve_warm`` at 256x256, at
   2048x2048 and (pipelined tiles pinned) at 768x768 on tv_bench's scene;
8. the card's own times: each FGP kernel, the plain loop and the bound per
   prox call from 256x256 to 2048x2048 at 30 and 8 dual iterations, one
   tile sweep per round of tiles, and the TV solves' wall time, kernel
   against plain;
9. backtracking LASSO at full width (``decay_rate=0.5``, ``lr=1``): nit,
   trials per iteration, iter/s against the fixed-step solve, host reads
   per iteration, device busy share; float64 on the card against float64
   on the CPU (50 iterations: same inner count, 1e-9 relative), float32
   against float64 (200 iterations, 1e-4);
10. the harness's 15 problems under every variant (plus the projected one
    for bounded problems), the first start of ``benchmark()``'s draw
    (one start per case, to leave phase 12 the time), float64, each solve
    on the card against the same solve on the CPU: a 12-iteration window
    (equal nit; equal nit_internal for m<=2, within 25% for m>=3; x within
    1e-8 for m<=2 and 1e-6 for m>=3) and the full solve (equal status, fun
    within 1e-6 relative); run in worker processes, one CPU thread each;
11. ``check_every=8``, ``iter_chunk=5`` and ``return_all`` solves on the
    card, bitwise equal to the ``check_every=1`` solve, for JOS1 with L1
    and for FDS;
12. the batch solver: (a) every phase-10 case as one batch of
    ``benchmark()``'s 100 starts (``history=True``), card against CPU lane
    by lane in phase 10's classes (all statuses equal, at most 10% of the
    lanes outside the classes: rounding-floor flips; m>=3 inner counts per
    batch), over the window and, for m<=2, to the end, with walls beside
    phase 10's single solves; (b) the 1k-lambda
    elastic-net sweep (A 500 x 2000, float32, fixed step), converged share,
    mean nit and solves/s, 8 lanes against single ``Lasso`` solves within
    1e-5; (c) JOS1 n=50 from 10,000 starts in float32, on the Pareto front;
    (d) FDS n=10 from 1,024 starts in float64, and ``lane_chunk=256``
    bitwise equal to the unchunked batch; (e) host reads and device events
    per outer iteration at 16 and 1,024 lanes, within 1%.  Phases 10 and 12's
    harness work shares one pool of worker processes.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is not 0.  Without a CUDA device it exits at once.
"""

from __future__ import annotations

import json
import math
import os
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
#: The fused LASSO kernel's entries (zfista_tpu_torch.ops.fused wrappers):
#: the TPU function each replaces.
LASSO_KERNELS = {
    "fused_prox_momentum": "zfista_tpu/ops/fused.py:62",
    "fista_tail": "zfista_tpu/ops/fused.py:144",
    "lasso_step_tail": "zfista_tpu/ops/fused.py:62",
}
#: Phase 2: vector lengths (edge cases, the main path's n, one past it, and
#: 10^7, past the L2).
FUSED_CHECK_SIZES = (1, 1000, N, 10_001, 10_000_000)
#: First iterations of the slice compared with the float64 numpy loop, and
#: the bound on their relative 2-norm difference: float32 rounding
#: (eps 6e-8) amplified over 200 momentum steps.
AGREE_ITERS, AGREE_RTOL = 200, 1e-4
SOURCES = ("fused_prox_momentum", "fgp_resident", "fgp_tiles")
#: Phase 6: images on which every FGP kernel is held against the plain loop
#: (the whole-image kernel where its bands fit shared memory).
TV_CHECK_CASES = (
    ((24, 40), torch.float32),
    ((100, 224), torch.float32),
    ((256, 256), torch.float32),
    ((360, 360), torch.float32),
    ((768, 768), torch.float32),
    ((1024, 1024), torch.float32),
    ((2048, 2048), torch.float32),
    # The tile windows' edges: serial 64x120 (interior 48x104), pipelined
    # 80x60 (interior 64x44) in float32; 64x60 (48x44) and 80x30 (64x14) in
    # float64.
    ((1, 105), torch.float32),
    ((49, 1), torch.float32),
    ((47, 103), torch.float32),
    ((48, 104), torch.float32),
    ((49, 105), torch.float32),
    ((65, 119), torch.float32),
    ((97, 209), torch.float32),
    ((49, 45), torch.float32),
    ((63, 43), torch.float32),
    ((64, 44), torch.float32),
    ((65, 45), torch.float32),
    ((81, 59), torch.float32),
    ((129, 87), torch.float32),
    ((100, 224), torch.float64),
    ((49, 45), torch.float64),
    ((97, 15), torch.float64),
    ((65, 15), torch.float64),
    ((64, 14), torch.float64),
    ((81, 29), torch.float64),
    ((256, 256), torch.float64),  # the cameraman through the whole-image kernel
    ((600, 520), torch.float64),  # a tile-kernel size
)
#: Phase 7: the cameraman's side, and the sides and prox methods of the
#: solve_warm runs on tv_bench's scene: "auto" picks the serial tiles at
#: 2048x2048; the pipelined tiles win at no size (tv_cuda.choose), so
#: their run pins them.
CAMERAMAN = 256
TV_BENCH_RUNS = ((2048, "auto"), (768, "cuda_tiles_pipelined"))
#: Phase 8: image sides and dual iterations at which each prox call is
#: timed (the main path runs 30 in TVDeblur.solve, 8 in solve_warm).
TV_TIME_SIZES = (256, 384, 512, 640, 768, 1024, 2048)
TV_TIME_ITERS = (30, 8)
#: NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core
#: float32 and float64 rates (the bounds of the kernels line).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
#: Operations per cell: one FGP iteration (div 5, grad 2, the two descent
#: steps 4, projection 7, momentum 6) and the pass that recovers u (5).
FLOPS_PER_CELL_ITER, FLOPS_PER_CELL_U = 24, 5
#: Fields one prox call must move: v, p0, q0 in; u, p, q out.
FIELDS_MOVED = 6
#: Cycles the stream is held before a timed FGP chain (~20 ms at the H100's
#: clocks): the host queues every call meanwhile, so the events time the
#: device, not the host's launch rate (a prox call costs the host tens of
#: microseconds, more than a small image's kernel).
HOLD_CYCLES = 40_000_000
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


def make_problem(m: int = M, n: int = N):
    """bench.py's problem: numpy seed 0, A/sqrt(m), 100-sparse x_true."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m)).astype(
        np.float32
    )
    x_true = np.zeros(n, np.float32)
    idx = rng.choice(n, 100, replace=False)
    x_true[idx] = rng.standard_normal(100).astype(np.float32)
    b = (A @ x_true + 0.01 * rng.standard_normal(m).astype(np.float32)).astype(
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
    """Device milliseconds per call of ``fn``, by CUDA events over ``reps``.
    The stream is held ~40 ms first, so that the host queues the calls
    meanwhile and they run back to back: a call that costs the host more
    than its kernel costs the card is still timed on the card (as long as
    ``reps`` launches fit the launch queue)."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(80_000_000)
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


def fgp_bound(shape: tuple[int, int], dtype: torch.dtype, n_iter: int) -> tuple[float, str]:
    """The least ms the card could take for one prox call, and what binds:
    the 6 fields moved once over the HBM rate, or the operations over the
    non-tensor-core rate of ``dtype``."""
    n = shape[0] * shape[1]
    item = torch.empty((), dtype=dtype).element_size()
    t_bytes = FIELDS_MOVED * n * item / PEAK_BYTES_PER_S
    t_ops = n * (FLOPS_PER_CELL_ITER * n_iter + FLOPS_PER_CELL_U) / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chain_ms(fn, v0, lam, n_iter: int, calls: int = 20) -> float:
    """Device ms per prox call over ``calls`` chained calls (each call's u
    is the next call's v), by CUDA events, after one warm-up call.  The
    stream is held first (:data:`HOLD_CYCLES`) so that the calls run back
    to back; a chain that takes the host longer to queue than the hold
    (the plain loop) is timed at the host's rate."""
    z = torch.zeros_like(v0)
    fn(lam, v0, z, z, n_iter)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    v = v0
    for _ in range(calls):
        v = fn(lam, v, z, z, n_iter)[0]
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def fgp_times(dev, side: int, n_iter: int, names) -> dict[str, list[float]]:
    """Device ms per prox call of each FGP kernel in ``names`` on a
    ``side`` x ``side`` float32 image (numpy seed 8, lam 0.05, zero duals),
    timed in turns: each name in order, then in reverse.  It drives only
    the wrappers ``fgp_resident`` and ``fgp_tiles`` of the
    ``zfista_tpu_torch`` it imports, so run from the root of another tree
    of the repository with this file copied there, it times that tree's
    kernels the same way."""
    fns = tv_kernel_fns()
    rng = np.random.default_rng(8)
    lam = torch.tensor(0.05, device=dev)
    v0 = torch.tensor(rng.standard_normal((side, side)), dtype=torch.float32, device=dev)
    runs: dict[str, list[float]] = {k: [] for k in names}
    for order in (list(names), list(reversed(names))):
        for k in order:
            runs[k].append(chain_ms(fns[k], v0, lam, n_iter))
    return runs


def sweep_ms(dev, side: int, k: int, pipelined: bool, reps: int = 50) -> tuple[float, int]:
    """Device ms of ONE tile sweep of ``k`` <= 8 iterations on a ``side`` x
    ``side`` float32 image (numpy seed 8, lam 0.05, a feasible dual; no pass
    for u), and the rounds of tiles it makes: tiles over SMs, rounded up
    (the pipelined kernel's persistent CTAs walk that many tiles each; the
    serial kernel's CTAs come in that many waves).  CUDA events over
    ``reps`` launches behind a stream hold; every launch reads the same
    buffers, so it times whatever the entry does with them."""
    import ctypes

    from zfista_tpu_torch.ops import _build, tv_cuda

    rng = np.random.default_rng(8)
    v, p, q = (
        torch.tensor(rng.uniform(-0.5, 0.5, (side, side)), dtype=torch.float32, device=dev)
        for _ in range(3)
    )
    lam = torch.tensor(0.05, device=dev)
    dst = [torch.empty_like(v) for _ in range(4)]
    wh, ww = tv_cuda.tile_window(torch.float32, pipelined)
    sweep = _build.entry(
        "fgp_tiles",
        f"zt_fgp_tiles_{'pipelined' if pipelined else 'serial'}_f32",
        10,
        (ctypes.c_double,) + (ctypes.c_int,) * 6,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        code = sweep(
            v.data_ptr(), p.data_ptr(), q.data_ptr(), p.data_ptr(), q.data_ptr(),
            lam.data_ptr(), *(f.data_ptr() for f in dst),
            1.0, side, side, k, 1, wh, ww, dev.index, stream,
        )
        if code != 0:
            raise RuntimeError(f"tile sweep launch failed: cudaError {code}")

    launch()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    stop.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds = -(-tv_cuda.n_tiles((side, side), torch.float32, pipelined) // sms)
    return start.elapsed_time(stop) / reps, rounds


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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (so +0 != -0), except that a NaN equals any NaN: the
    kernels write the canonical one, ``torch.amax`` hands on whichever it
    met."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    same = (a.view(bits) == b.view(bits)) | (torch.isnan(a) & torch.isnan(b))
    return bool(torch.all(same))


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the entries that are not NaN in both."""
    d = torch.abs(a.double() - b.double())
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(torch.max(d)) if d.numel() else 0.0


def step_tail_cases(y, g, x, dtype, dev) -> dict:
    """Phase 2's states for the solver's step tail: keyword arguments of
    ``fused.lasso_step_tail`` by case name."""

    def scalar(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    base = dict(
        y=y, grad=g, x=x, t=scalar(3.7), lr=scalar(0.1), lam=scalar(0.5),
        err=scalar(0.25), nit=scalar(41, torch.int32),
        nit_internal=scalar(43, torch.int32), converged=scalar(False, torch.bool),
        failed=scalar(False, torch.bool), a=0.25, b=0.3, tol=0.0, max_iter=1000,
    )
    y_nan = y.clone()
    y_nan[y.numel() // 2] = float("nan")
    return {
        "active": base,
        "converging": dict(base, tol=1e30),
        "converged": dict(base, converged=scalar(True, torch.bool)),
        "failed": dict(base, failed=scalar(True, torch.bool)),
        "at max_iter": dict(base, max_iter=41),
        "NaN, active": dict(base, y=y_nan, tol=1e30),
        "NaN, stopped": dict(base, y=y_nan, err=scalar(float("nan")), max_iter=7),
    }


def phase2(dev) -> dict[str, float]:
    """The fused LASSO kernel's three entries against their plain versions
    on the card.  Stated tolerance: 0.  The kernel is built with
    -fmad=false and the plain versions compute in the same operation order,
    so they are bitwise equal; any difference is a fault."""
    from zfista_tpu_torch.ops import fused

    rng = np.random.default_rng(1)
    counts = fused.launch_counts
    max_err = dict.fromkeys(LASSO_KERNELS, 0.0)

    def held(name, got, ref, what):
        err = max(abs_err(a, b) for a, b in zip(got, ref))
        max_err[name] = max(max_err[name], err)
        if err != 0.0 or not all(same_bits(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} vs plain, {what}: max_abs_err {err!r}")

    for dtype in (torch.float32, torch.float64):
        for n in FUSED_CHECK_SIZES:
            y, g, x = (
                torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
                for _ in range(3)
            )
            before = dict(counts)
            scal = [torch.tensor(v, dtype=dtype, device=dev) for v in (0.1, 0.05, 0.3)]
            held(
                "fused_prox_momentum",
                fused.fused_prox_momentum(y, g, x, *scal),
                fused.fused_prox_momentum_plain(y, g, x, *scal),
                f"{dtype} n={n}",
            )
            scal = [torch.tensor(v, dtype=dtype, device=dev) for v in (3.7, 0.1, 0.5)]
            held(
                "fista_tail",
                fused.fista_tail(y, g, x, *scal),
                fused.fista_tail_plain(y, g, x, *scal),
                f"{dtype} n={n}",
            )
            cases = step_tail_cases(y, g, x, dtype, dev)
            flags = {}
            for what, kw in cases.items():
                got = fused.lasso_step_tail(**kw)
                ref = fused.lasso_step_tail_plain(**kw)
                held("lasso_step_tail", got, ref, f"{dtype} n={n}, {what}")
                flags[what] = (bool(got.converged), int(got.nit), float(got.err))
            torch.cuda.synchronize()
            launched = {k: counts[k] - before[k] for k in counts}
            log(
                f"phase 2: {str(dtype)[6:]} n={n}: fused_prox_momentum, fista_tail and "
                f"lasso_step_tail (states {list(cases)}) == plain bitwise (tolerance 0); "
                f"launches +{launched}; step tail (converged, nit, err) {flags}"
            )
            want = {"fused_prox_momentum": 1, "fista_tail": 1, "lasso_step_tail": len(cases)}
            if launched != want:
                raise AssertionError(f"phase 2 launches {launched}, expected {want}")
            if not (flags["converging"][0] and not flags["active"][0]
                    and flags["active"][1] == 42 and flags["at max_iter"][1] == 41
                    and math.isnan(flags["NaN, active"][2])):
                raise AssertionError(f"phase 2: step tail flags {flags}")

    # err < tol is taken in the tensor's dtype: float32(1e-5) is below the
    # double 1e-5, so a float32 err of exactly float32(1e-5) converges only
    # in a comparison that keeps tol in double.
    one = torch.ones(1, dtype=torch.float32, device=dev)
    e = torch.tensor([1e-5], dtype=torch.float32, device=dev)
    kw = step_tail_cases(0 * one, -e, 0 * one, torch.float32, dev)["active"]
    kw.update(lr=one[0].clone(), lam=0 * one[0], tol=1e-5)
    got, ref = fused.lasso_step_tail(**kw), fused.lasso_step_tail_plain(**kw)
    held("lasso_step_tail", got, ref, "err == float32(tol)")
    log(
        f"phase 2: err == float32(tol) = {float(got.err)!r} against tol 1e-5: converged "
        f"{bool(got.converged)} in the kernel, {bool(ref.converged)} in the plain version"
    )
    torch.cuda.synchronize()
    left = [int(v) for s_ in fused._SCRATCH.values() for v in s_.cpu()]
    if any(left):
        raise AssertionError(f"phase 2: the step tail left its scratch words at {left}")
    return max_err


def phase6(dev) -> dict[str, float]:
    """The FGP kernels against the plain loop on the card.  Stated
    tolerance: 0.  The kernels are built with -fmad=false and compute the
    plain loop's operations in its order with correctly rounded sqrt and
    division, so they are bitwise equal to it; any difference is a fault."""
    from zfista_tpu_torch.ops import tv, tv_cuda

    counts = tv_cuda.launch_counts
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(6)
    max_err = dict.fromkeys(tv_kernel_fns(), 0.0)
    for shape, dtype in TV_CHECK_CASES:
        kernels = {
            name: fn
            for name, fn in tv_kernel_fns().items()
            if name != "fgp_resident" or tv_cuda.fits_resident(shape, dtype, sms)
        }
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
        want = {name: want[name] for name in kernels}
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


def phase7(dev, card: str) -> tuple[dict[str, int], dict[str, tuple[int, int]]]:
    """The TV slice through the public entry points.  Each FGP kernel's
    main-path run is the first run below that goes through it: the
    500-iteration ``solve`` (the whole-image kernel at 256x256) and the
    ``solve_warm`` runs on tv_bench's scene (the serial tiles by ``auto``
    at 2048x2048, the pipelined tiles pinned at 768x768).  Every
    count is set to 0 just before each run and read just after.  Returns
    each kernel's launches in its main-path run, and that run's image
    side and dual iterations per prox call."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.models import deblur as td
    from zfista_tpu_torch.ops import tv_cuda

    counts = tv_cuda.launch_counts
    truth_t = td.synthetic_cameraman(CAMERAMAN, dtype=torch.float64, device=dev)
    truth = truth_t.cpu().numpy()
    observed = td.make_blur(td.gaussian_kernel())(truth_t).cpu().numpy()
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
        f"phase 7 [{card}]: TVDeblur(cameraman {CAMERAMAN}x{CAMERAMAN} f32, tv_ratio 2e-4, "
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
    main_launches, runs = {kern: launched[kern]}, {kern: (CAMERAMAN, kw["prox_iter"])}
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
            f"phase 7 [{card}]: default-tol solve, check_every={ce}: status={conv[ce].status} "
            f"nit={conv[ce].nit} err={conv[ce].error_criterion!r} "
            f"wall {time.perf_counter() - t0:.3f} s"
        )
    for name, a, c in zip(conv[1].state._fields, conv[1].state, conv[64].state):
        if not np.array_equal(a, c):
            raise AssertionError(f"check_every=64 differs from 1 in State.{name}")
    log("phase 7: check_every=64 is bitwise equal to check_every=1 (x, nit, State)")

    scenes = [(CAMERAMAN, td.gaussian_kernel(), observed, 2e-4, "auto")]
    scenes += [(n, *tv_bench_scene(n, dev), 1e-3, m) for n, m in TV_BENCH_RUNS]
    for size, kernel, obs, tv_ratio, method in scenes:
        b = torch.tensor(obs, dtype=torch.float32, device=dev)
        prob = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method=method)
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
            f"phase 7 [{card}]: solve_warm(max_iter=200, prox_iter=8) at {size}x{size} f32: "
            f"prox_method {method!r} runs {kind}; nit={w['nit']} fun={w['fun']!r} "
            f"wall {wall:.3f} s; "
            f"launches {used}; == plain-prox solve_warm bitwise: {same}"
        )
        if w["nit"] != 200 or not np.all(np.isfinite(w["x"])) or not same:
            raise AssertionError(f"solve_warm at {size}: wrong nit, non-finite or != plain")
        if used[kinds[kind]] < 200:
            raise AssertionError(f"solve_warm at {size} launched {used}")
        if kinds[kind] not in runs:
            main_launches[kinds[kind]] = used[kinds[kind]]
            runs[kinds[kind]] = (size, 8)

    for name in TV_KERNELS:
        if not main_launches.get(name):
            raise AssertionError(f"the TV slice never launched {name}")
    log(f"phase 7: main-path launches {main_launches} at (image side, n_iter) {runs}")
    return main_launches, runs


def phase8(dev, card: str) -> dict[tuple[int, int], dict[str, float]]:
    """The card's times of the TV slice.  Returns device ms per prox call by
    (image side, n_iter) and implementation: each FGP kernel (the
    whole-image kernel where its bands fit), the plain loop, and the
    bound."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.models import deblur as td
    from zfista_tpu_torch.ops import tv_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lam = torch.tensor(0.05, device=dev)
    ms: dict[tuple[int, int], dict[str, float]] = {}
    for n in TV_TIME_SIZES:
        names = [
            name
            for name in tv_kernel_fns()
            if name != "fgp_resident" or tv_cuda.fits_resident((n, n), torch.float32, sms)
        ]
        v0 = torch.tensor(
            np.random.default_rng(8).standard_normal((n, n)), dtype=torch.float32, device=dev
        )
        for n_iter in TV_TIME_ITERS:
            runs = fgp_times(dev, n, n_iter, names)
            plain = chain_ms(tv_cuda.fgp_plain, v0, lam, n_iter, calls=5)
            b_ms, b_by = fgp_bound((n, n), torch.float32, n_iter)
            ms[n, n_iter] = {k: min(v) for k, v in runs.items()}
            ms[n, n_iter].update(fgp_plain=plain, bound_ms=b_ms)
            log(
                f"phase 8 [{card}]: prox call {n}x{n} f32 n_iter={n_iter}, device ms per "
                f"call (20 chained calls, CUDA events, runs {{k: [..]}}): "
                + ", ".join(f"{k} {min(v):.4f} {[round(x, 4) for x in v]}" for k, v in runs.items())
                + f"; plain {plain:.4f} (host-bound); bound {b_ms:.4f} ({b_by}); auto picks "
                + tv_cuda.choose((n, n), torch.float32, sms)
            )

    for n, _ in TV_BENCH_RUNS:
        for k in (tv_cuda.HALO, TV_TIME_ITERS[0] % tv_cuda.HALO):
            parts = []
            for pipelined in (False, True):
                t_ms, rounds = sweep_ms(dev, n, k, pipelined)
                parts.append(
                    f"{'pipelined' if pipelined else 'serial'} {t_ms:.4f} in {rounds} "
                    f"round(s) of tiles, {t_ms / rounds:.4f} per round"
                )
            log(
                f"phase 8 [{card}]: one tile sweep of {k} iterations at {n}x{n} f32, "
                f"device ms (50 launches, CUDA events): " + "; ".join(parts)
            )

    truth_t = td.synthetic_cameraman(CAMERAMAN, dtype=torch.float64, device=dev)
    observed = td.make_blur(td.gaussian_kernel())(truth_t).cpu().numpy()
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
            f"phase 8 [{card}]: TVDeblur {what} at {CAMERAMAN}x{CAMERAMAN} f32 wall s: kernel "
            f"{[round(x, 4) for x in walls['auto']]}, plain prox "
            f"{[round(x, 4) for x in walls['xla']]}"
        )
    return ms


def count_host_reads(fn) -> tuple:
    """``fn()``'s result and the host reads (stream synchronizations) it
    made, counted by ``torch.cuda.set_sync_debug_mode``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def device_events(fn, by_name: bool = False) -> tuple:
    """``fn()``'s device events by torch.profiler: how many there were
    (kernel launches and copies) and the sum of their own time in µs (one
    stream, no overlap), as the profiler table's "Self CUDA time total"
    sums them; with ``by_name`` also the count of each event's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    out = (
        sum(e.count for e in on_device),
        float(sum(e.self_device_time_total for e in on_device)),
    )
    return out + ({e.key: e.count for e in on_device},) if by_name else out


def lasso_loops(dev, card: str, iters: int = 256) -> dict[str, dict[str, float]]:
    """Per iteration of the fixed-step LASSO slice (the module's problem at
    full width): wall µs without the profiler (three runs in turns, the
    least), then device events and their busy µs with it, for the public
    path (``Lasso.solve_fixed_step``, tol 0, ``iters`` iterations) and the
    raw loops over the fused and the plain dense step.  It drives only the
    port's public functions, so run from the root of another tree of the
    repository with this file copied there, it measures that tree."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.ops import fused

    A_np, b_np = make_problem()
    A, b = torch.as_tensor(A_np, device=dev), torch.as_tensor(b_np, device=dev)
    prob = Lasso(A, b, LAM)
    lr_f = 1.0 / prob.lipschitz()
    lr = torch.tensor(lr_f, dtype=torch.float32, device=dev)
    lam = torch.tensor(LAM, dtype=torch.float32, device=dev)
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)

    def raw(step):
        def run():
            c = (x0, x0, torch.tensor(1.0, device=dev))
            for _ in range(iters):
                c = step(A, b, lam, lr, c)
        return run

    runs = {
        "public": lambda: quiet(prob.solve_fixed_step, x0, lr=lr_f, tol=0, max_iter=iters),
        "raw_fused": raw(fused.fista_step_dense_fused),
        "raw_plain": raw(fista_step_dense),
    }
    for fn in runs.values():
        fn()
    walls: dict[str, list[float]] = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs)), list(runs)):
        for k in order:
            walls[k].append(1e6 * sync_time(runs[k]) / iters)
    out = {}
    for k, fn in runs.items():
        n_events, busy = device_events(fn)
        out[k] = {
            "wall_us": min(walls[k]),
            "launches": n_events / iters,
            "busy_us": busy / iters,
        }
        log(
            f"lasso loops [{card}]: {k}, {iters} iterations: wall {min(walls[k]):.1f} us/iteration "
            f"(least of {[round(w, 1) for w in walls[k]]}, no profiler); torch.profiler: "
            f"{n_events / iters:.2f} device events/iteration, busy {busy / iters:.1f} us/iteration "
            f"(share of that wall {busy / iters / min(walls[k]):.3f})"
        )
    return out


def phase9(dev, card: str, A, b, A_np, b_np, lr_fixed: float) -> dict:
    """Backtracking LASSO at full width: ``Lasso.solve`` with the default
    ``decay_rate=0.5`` and ``lr=1``, against the fixed-step solve."""
    from zfista_tpu_torch.models import Lasso

    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    res = Lasso(A, b, LAM).solve(x0, nesterov=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(
        f"phase 9 [{card}]: Lasso(m={M}, n={N}, f32, lambda={LAM}).solve(nesterov=True) "
        f"(decay_rate 0.5, lr 1, tol 1e-5): status={res.status} nit={res.nit} "
        f"nit_internal={res.nit_internal} trials/iteration={res.nit_internal / res.nit!r} "
        f"lr={res.lr!r} fun={float(res.fun[0])!r} wall {wall:.3f} s"
    )
    if res.status != 1 or not np.all(np.isfinite(res.x)) or res.x.shape != (N,):
        raise AssertionError("backtracking LASSO: no convergence or non-finite x")

    # iter/s, backtracking against fixed step, in turns (after a warm-up).
    iters = 500
    runs = {
        "backtracking": lambda: Lasso(A, b, LAM).solve(x0, nesterov=True, tol=0, max_iter=iters),
        "fixed_step": lambda: Lasso(A, b, LAM).solve_fixed_step(
            x0, lr=lr_fixed, tol=0, max_iter=iters
        ),
    }
    for fn in runs.values():
        quiet(fn)
    rates: dict[str, list[float]] = {k: [] for k in runs}
    for k in ("backtracking", "fixed_step", "fixed_step", "backtracking"):
        rates[k].append(iters / sync_time(lambda: quiet(runs[k])))
    reads = {}
    for k, fn in runs.items():
        r, n_reads = count_host_reads(fn)
        reads[k] = n_reads / r.nit
    busy = {k: device_events(lambda: quiet(fn))[1] for k, fn in runs.items()}
    for k in runs:
        wall_us = 1e6 * iters / statistics.mean(rates[k])
        share = busy[k] / wall_us if busy[k] else float("nan")
        log(
            f"phase 9 [{card}]: {k} {iters} iterations (tol 0): "
            f"{[round(r, 1) for r in rates[k]]} iter/s; host reads/iteration "
            f"{reads[k]!r}; device busy {busy[k] / iters:.1f} us/iteration (torch.profiler), "
            f"share of the unprofiled wall {share:.3f}"
            + ("" if busy[k] else " (profiler showed no device time: not measured)")
        )

    # float64 on the card against float64 on the CPU: the first 50
    # iterations take the same trials and agree to 1e-9 relative.
    kw = dict(nesterov=True, tol=0, max_iter=50)
    A64, b64 = A.double(), b.double()
    card64 = quiet(Lasso(A64, b64, LAM).solve, torch.zeros(N, dtype=torch.float64, device=dev), **kw)
    cpu64 = quiet(
        Lasso(torch.tensor(A_np, dtype=torch.float64), torch.tensor(b_np, dtype=torch.float64), LAM).solve,
        torch.zeros(N, dtype=torch.float64), **kw,
    )
    rel64 = float(np.linalg.norm(card64.x - cpu64.x) / np.linalg.norm(cpu64.x))
    log(
        f"phase 9: float64, 50 iterations, card vs CPU: nit_internal {card64.nit_internal} vs "
        f"{cpu64.nit_internal}; x relative 2-norm diff {rel64!r} (bound 1e-9)"
    )
    if card64.nit_internal != cpu64.nit_internal or card64.nit != 50 or not rel64 <= 1e-9:
        raise AssertionError("backtracking LASSO: float64 card and CPU solves differ")
    kw["max_iter"] = 200
    x32 = quiet(Lasso(A, b, LAM).solve, x0, **kw)
    x64 = quiet(Lasso(A64, b64, LAM).solve, torch.zeros(N, dtype=torch.float64, device=dev), **kw)
    rel32 = float(np.linalg.norm(x32.x - x64.x) / np.linalg.norm(x64.x))
    log(
        f"phase 9: float32 vs float64 on the card, 200 iterations: relative 2-norm diff "
        f"{rel32!r} (bound {AGREE_RTOL}); nit_internal {x32.nit_internal} vs {x64.nit_internal}"
    )
    if not rel32 <= AGREE_RTOL:
        raise AssertionError("backtracking LASSO: float32 disagrees with float64")
    return {"rates": rates, "reads": reads, "busy_us": busy}


#: Phase 10: the benchmark harness's problem list (zfista_tpu/bench/
#: harness.py, initialize_problems(large=False)) and its variants.
VARIANTS = {
    "Normal": dict(nesterov=False),
    "Accelerated": dict(nesterov=True),
    "Accelerated (deprecated)": dict(nesterov=True, deprecated=True),
}
PROJECTED_VARIANT = {"Accelerated (projected)": dict(nesterov=True, project_momentum=True)}
#: Phase 10 solves one start per case (the first of benchmark()'s draw),
#: phase 12 batches benchmark()'s 100.
HARNESS_STARTS, HARNESS_TOL_INTERNAL, HARNESS_MAX_ITER, WINDOW = 1, 1e-11, 10_000, 12
BATCH_STARTS = 100
#: Worker processes for phases 10 and 12 (at most the machine's cores less one).
PHASE10_WORKERS = 7


def harness_problems() -> list:
    """``initialize_problems(large=False)``: (problem, low, high) x 15."""
    from zfista_tpu_torch.models import FDS, JOS1, SD, TOI4, TRIDIA, ZDT1, LinearFunctionRank1

    out = []
    for n in (5, 50):
        out.append((JOS1(n_features=n), -2.0, 4.0))
        out.append((JOS1(n_features=n, l1_ratios=[1.0 / n, 2.0 / n], l1_shifts=[0.0, -1.0]), -2.0, 4.0))
    out.append((SD(), 1.0, 2.0))
    n = 10
    out.append((FDS(n_features=n), -2.0, 2.0))
    out.append((FDS(n_features=n, l1_ratios=[1.0 / n] * 3, l1_shifts=[0.0, 1.0, -1.0]), -2.0, 2.0))
    out.append((FDS(n_features=n, bounds=(0.0, math.inf)), 0.0, 2.0))
    out.append((ZDT1(n_features=50), 0.01, 1.0))
    out.append((TOI4(), -2.0, 5.0))
    out.append((TOI4(l1_ratios=[0.25, 0.25], l1_shifts=[0.0, 0.0]), -2.0, 5.0))
    out.append((TRIDIA(), -1.0, 1.0))
    out.append((TRIDIA(l1_ratios=[0.5, 0.5, 0.5], l1_shifts=[0.0, 0.0, 0.0]), -1.0, 1.0))
    out.append((LinearFunctionRank1(n_features=30), -1.0, 1.0))
    out.append(
        (LinearFunctionRank1(n_features=30, l1_ratios=[0.01] * 4, l1_shifts=[0.0] * 4), -1.0, 1.0)
    )
    return out


def variants_of(problem) -> dict:
    out = dict(VARIANTS)
    if problem.bounds is not None:
        out.update(PROJECTED_VARIANT)
    return out


def _worker_init(dev: str) -> None:
    """One CPU thread; the precision policy; and one small solve and batch
    on each device, so that the first-use costs of CUDA and torch.func
    (seconds) fall outside every timed solve."""
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from zfista_tpu_torch.models import TRIDIA

    for d in (dev, "cpu"):
        TRIDIA().solve(torch.full((3,), 0.5, dtype=torch.float64, device=d), max_iter=2)
        TRIDIA().solve_batch(torch.full((2, 3), 0.5, dtype=torch.float64, device=d), max_iter=2)


def harness_solve(task: tuple) -> dict:
    """One phase-10 solve or phase-12 batch, in a worker process:
    ``(problem index, variant, start, device, window)``, with start
    ``None`` for the batch of all ``BATCH_STARTS`` starts (``history=True``,
    as ``benchmark()`` runs it).  Starts are drawn as ``benchmark()`` draws
    them (numpy seed 42, the problem's sampling box); a single solve takes
    one row of that draw.  Fields per lane: a single solve is one lane."""
    if task[0] == "fds_wide":
        return fds_wide(task[1])
    i, variant, k, device, window = task
    problem, low, high = harness_problems()[i]
    x0s = np.random.default_rng(42).uniform(low, high, size=(BATCH_STARTS, problem.n_features))
    kw = dict(tol_internal=HARNESS_TOL_INTERNAL, **variants_of(problem)[variant])
    kw.update(dict(max_iter=WINDOW, tol=0) if window else dict(max_iter=HARNESS_MAX_ITER))
    t0 = time.perf_counter()
    if k is None:
        res = problem.solve_batch(torch.tensor(x0s, device=device), history=True, **kw)
    else:
        res = problem.solve(torch.tensor(x0s[k], device=device), **kw)
    wall = time.perf_counter() - t0
    lanes = 1 if k is not None else BATCH_STARTS
    return dict(
        nit=np.reshape(res.nit, lanes), nit_internal=np.reshape(res.nit_internal, lanes),
        status=np.reshape(res.status, lanes), x=np.reshape(res.x, (lanes, -1)),
        fun=np.reshape(res.fun, (lanes, -1)), wall=wall,
    )


def run_pool(card: str, dev, tasks: list) -> dict:
    """Phases 10 and 12's solves in worker processes, one CPU thread each:
    the solves are host-bound (hundreds of small launches per outer
    iteration).  The longest first (batches, full solves, several
    objectives, on the card), so that no long one starts last."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    problems = harness_problems()

    def order(t):
        if t[0] == "fds_wide":
            return (-1, 0, 0, False)
        return (t[2] is not None, t[4], -problems[t[0]][0].n_objectives, t[3] == "cpu")

    tasks = sorted(tasks, key=order)
    workers = max(2, min(PHASE10_WORKERS, (os.cpu_count() or 2) - 1))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
        workers,
        mp_context=mp.get_context("spawn"),
        initializer=_worker_init,
        initargs=(str(dev),),
    ) as pool:
        results = dict(zip(tasks, pool.map(harness_solve, tasks)))
    log(
        f"phases 10 and 12 [{card}]: {len(tasks)} solves and batches in {workers} worker "
        f"processes: {time.perf_counter() - t0:.1f} s"
    )
    return results


def compare_lanes(wc: dict, wp: dict, fc: dict | None, fp: dict | None, m: int) -> list[tuple]:
    """Card against CPU, lane by lane: over the window equal nit, equal
    nit_internal for m<=2 (within 25% for m>=3), x within 1e-8 (m<=2) or
    1e-6; to the end (when run) equal status and fun within 1e-6 relative.
    Returns (ok, dx, dfun, inner difference) per lane."""
    x_tol = 1e-8 if m <= 2 else 1e-6
    out = []
    for j in range(len(wc["nit"])):
        dx = float(np.max(np.abs(wc["x"][j] - wp["x"][j])))
        # m>=3: the Newton dual's stall and arc tests sit at the rounding
        # floor, where cuBLAS and the CPU's BLAS round differently, so its
        # inner count is not reproducible across devices (rank-one
        # LinearFunctionRank1: up to 16% on the H100; the CPU port against
        # JAX: up to 24%).  The bound only catches a Newton loop gone wrong.
        d_int = abs(int(wc["nit_internal"][j]) - int(wp["nit_internal"][j]))
        ok = (
            wc["nit"][j] == wp["nit"][j]
            and (d_int == 0 if m <= 2 else d_int <= 0.25 * wp["nit_internal"][j])
            and dx <= x_tol
        )
        dfun = 0.0
        if fc is not None:
            scale = np.maximum(np.abs(fp["fun"][j]), 1e-300)
            dfun = float(np.nanmax(np.abs(fc["fun"][j] - fp["fun"][j]) / scale))
            ok = ok and fc["status"][j] == fp["status"][j] and (
                dfun <= 1e-6 or np.array_equal(fc["fun"][j], fp["fun"][j], equal_nan=True)
            )
        out.append((ok, dx, dfun, d_int))
    return out


def phase10_tasks(dev) -> list:
    return [
        (i, v, k, d, w)
        for i, (p, _, _) in enumerate(harness_problems())
        for v in variants_of(p)
        for k in range(HARNESS_STARTS)
        for w in (False, True)
        for d in (str(dev), "cpu")
    ]


def phase10(card: str, dev, results: dict) -> dict:
    """The harness's 15 problems under every variant, ``HARNESS_STARTS``
    start each, float64: every solve on the card against the same solve
    on the CPU, over a ``WINDOW``-iteration window (tol 0) and to the end
    (``compare_lanes``).  The solves ran in ``run_pool``'s workers; the
    walls printed are per solve inside that pool.  Returns the walls per
    (problem, variant)."""
    failures, inner = [], []
    walls: dict[tuple[str, str], dict[str, list[float]]] = {}
    problems = harness_problems()
    for i, (p, _, _) in enumerate(problems):
        m = p.n_objectives
        dev_x = dev_fun = 0.0
        statuses = []
        for v in variants_of(p):
            for k in range(HARNESS_STARTS):
                wc, wp = results[(i, v, k, str(dev), True)], results[(i, v, k, "cpu", True)]
                fc, fp = results[(i, v, k, str(dev), False)], results[(i, v, k, "cpu", False)]
                ((ok, dx, dfun, d_int),) = compare_lanes(wc, wp, fc, fp, m)
                dev_x, dev_fun = max(dev_x, dx), max(dev_fun, dfun)
                statuses.append(int(fc["status"][0]))
                if d_int:
                    inner.append(
                        f"{p.name} / {v} / start {k}: {wc['nit_internal'][0]} vs {wp['nit_internal'][0]}"
                    )
                if not ok:
                    failures.append(
                        f"{p.name} / {v} / start {k}: window nit {wc['nit']}/{wp['nit']} "
                        f"nit_internal {wc['nit_internal']}/{wp['nit_internal']} dx {dx!r}; "
                        f"full status {fc['status']}/{fp['status']} nit {fc['nit']}/{fp['nit']} "
                        f"dfun {dfun!r}"
                    )
                w = walls.setdefault((p.name, v), {"cuda": [], "cpu": [], "nit": []})
                w["cuda"].append(fc["wall"])
                w["cpu"].append(fp["wall"])
                w["nit"].append(int(fc["nit"][0]))
        per_p = [walls[(p.name, v)] for v in variants_of(p)]
        log(
            f"phase 10 [{card}]: {p.name} (m={m}): statuses {statuses}; largest deviation card "
            f"vs CPU: x {dev_x!r} over {WINDOW} iterations (bound {1e-8 if m <= 2 else 1e-6}), "
            f"fun {dev_fun!r} relative at the end (bound 1e-6); wall per full solve, median: "
            f"card {statistics.median(x for w in per_p for x in w['cuda']):.3f} s, CPU "
            f"{statistics.median(x for w in per_p for x in w['cpu']):.3f} s "
            f"(nit {[n for w in per_p for n in w['nit']]})"
        )
    cases = sum(len(variants_of(p)) for p, _, _ in problems) * HARNESS_STARTS
    log(
        f"phase 10: window nit_internal card vs CPU differs in {len(inner)} of "
        f"{cases} cases (allowed for m>=3 only, within 25%): {inner}"
    )
    for f in failures:
        log(f"phase 10: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 10: {len(failures)} card/CPU mismatches")
    return walls


def phase11(card: str, dev) -> None:
    """``check_every=8``, ``iter_chunk=5`` and ``return_all`` solves on the
    card, bitwise against the ``check_every=1`` solve: x, nit, nit_internal
    and every State field; the history ends at the while driver's state."""
    from zfista_tpu_torch.models import FDS, JOS1

    cases = [
        (JOS1(n_features=50, l1_ratios=[1.0 / 50, 2.0 / 50], l1_shifts=[0.0, -1.0]), -2.0, 4.0),
        (FDS(n_features=10), -2.0, 2.0),
    ]
    for p, low, high in cases:
        x0 = np.random.default_rng(42).uniform(low, high, size=(HARNESS_STARTS, p.n_features))[0]
        kw = dict(nesterov=True, tol_internal=HARNESS_TOL_INTERNAL, max_iter=HARNESS_MAX_ITER)
        runs = {}
        for extra in ({"check_every": 1}, {"check_every": 8}, {"iter_chunk": 5}, {"return_all": True}):
            t0 = time.perf_counter()
            runs[str(extra)] = quiet(p.solve, torch.tensor(x0, device=dev), **kw, **extra)
            runs[str(extra)]["wall"] = time.perf_counter() - t0
        ref = runs[str({"check_every": 1})]
        counted, n_reads = count_host_reads(
            lambda: p.solve(torch.tensor(x0, device=dev), **kw)
        )
        log(
            f"phase 11: {p.name} accelerated (m={p.n_objectives}), check_every=1: host "
            f"reads per outer iteration {n_reads / counted.nit!r} ({n_reads} over "
            f"{counted.nit} iterations, {counted.nit_internal} inner)"
        )
        for name, r in runs.items():
            same = (r.nit, r.nit_internal) == (ref.nit, ref.nit_internal) and all(
                np.array_equal(a, c) and a.dtype == c.dtype for a, c in zip(r.state, ref.state)
            )
            if "return_all" in name:
                same = same and np.array_equal(r.allvecs[-1], ref.x) and len(r.allvecs) == ref.nit + 1
            log(
                f"phase 11 [{card}]: {p.name} accelerated, {name}: status {r.status} nit {r.nit} "
                f"nit_internal {r.nit_internal} wall {r['wall']:.3f} s; bitwise equal to "
                f"check_every=1 (x, nit, nit_internal, State{', history' if 'return_all' in name else ''}): {same}"
            )
            if not same or r.status != 1:
                raise AssertionError(f"phase 11: {p.name} {name} differs from check_every=1")


#: Phase 12: the batch solver (zfista_tpu_torch.parallel).  (a) the
#: harness's batches of BATCH_STARTS starts (full solves for m<=2; the
#: window for every problem); (b) the 1k-lambda elastic-net sweep
#: (BENCHMARKS.md "1k-lambda", BASELINE configs[2]): A 500 x 2000 by
#: make_problem, 1,000 lambdas log-spaced in 1e-4..1, mu 0.1, float32, fixed
#: step at 1/L, SWEEP_CHECK lanes held against single solves within
#: SWEEP_RTOL; (c) JOS1 n=50 from 10,000 starts, float32, tol 1e-5
#: (BENCHMARKS.md "10k-instance"); (d) FDS n=10 from 1,024 starts, float64,
#: and lane_chunk=256 bitwise over CHUNK_ITERS iterations; (e) host reads
#: and device events per outer iteration at COUNT_WIDTHS lanes (the 16
#: starts tiled), over COUNT_ITERS iterations, within COUNT_RTOL.
SWEEP_SHAPE, SWEEP_LAMBDAS, SWEEP_MU, SWEEP_CHECK, SWEEP_RTOL = (500, 2000), 1000, 0.1, 8, 1e-5
JOS1_LANES, FDS_LANES, FDS_CHUNK, CHUNK_ITERS = 10_000, 1024, 256, 20
COUNT_WIDTHS, COUNT_ITERS, COUNT_RTOL = (16, 1024), 10, 0.01


def phase12_tasks(dev) -> list:
    """Phase 12's pool work: every (problem, variant) batch over the window
    on both devices, to the end for m<=2, and (d)'s wide FDS batch."""
    tasks = [("fds_wide", str(dev))]
    for i, (p, _, _) in enumerate(harness_problems()):
        for v in variants_of(p):
            for d in (str(dev), "cpu"):
                tasks.append((i, v, None, d, True))
                if p.n_objectives <= 2:
                    tasks.append((i, v, None, d, False))
    return tasks


def fds_wide(device: str) -> dict:
    """(d), in a worker: FDS n=10 from FDS_LANES starts (benchmark()'s box,
    seed 42), float64, the harness's accelerated variant, to the end."""
    from zfista_tpu_torch.models import FDS

    x0s = np.random.default_rng(42).uniform(-2.0, 2.0, size=(FDS_LANES, 10))
    t0 = time.perf_counter()
    res = FDS(n_features=10).solve_batch(
        torch.tensor(x0s, device=device), nesterov=True, tol_internal=HARNESS_TOL_INTERNAL,
        max_iter=HARNESS_MAX_ITER,
    )
    wall = time.perf_counter() - t0
    return dict(status=res.status, nit=res.nit, x=res.x, wall=wall)


#: Phase 12a: the share of a batch's lanes that may fall outside phase 10's
#: classes card against CPU, each with the same status.  A hundred starts
#: find the lanes whose path turns on a rounding-floor decision (a marginal
#: line-search accept, a bisection end point, a Newton stall test); the
#: single solves of phase 10 met none.  On the CPU alone a start changed by
#: one part in 1e15 moves such a lane's inner count (JOS1 n=5 with L1,
#: accelerated, start 53: 24 to 98; FDS start 54: 379 to 258 Newton steps)
#: and, after a flip, the point where it stops within tol.
BATCH_OUTLIERS = 0.1


def phase12a(card: str, dev, results: dict, singles: dict) -> None:
    """The harness's 15 problems under every variant as ``benchmark()``
    runs them: one batch of ``BATCH_STARTS`` starts, ``history=True``,
    float64, card against CPU lane by lane in phase 10's classes
    (``compare_lanes``), over the window for every problem, to the end for
    m<=2 (an m>=3 batch of 100 starts runs for minutes on either device;
    (d) runs one to the end).  Every lane must end with the same status,
    at most ``BATCH_OUTLIERS`` of a batch's lanes may fall outside the
    classes (each printed), and for m>=3 the inner counts are held per
    batch (its total within 25%): per lane they are not reproducible.
    Walls per batch inside the pool, beside phase 10's single solves."""
    failures = []
    problems = harness_problems()
    for i, (p, _, _) in enumerate(problems):
        m = p.n_objectives
        for v in variants_of(p):
            wc, wp = results[(i, v, None, str(dev), True)], results[(i, v, None, "cpu", True)]
            full = m <= 2
            fc = results[(i, v, None, str(dev), False)] if full else None
            fp = results[(i, v, None, "cpu", False)] if full else None
            if m >= 3:  # inner counts per batch (below), not per lane
                wc_lanes = dict(wc, nit_internal=wp["nit_internal"])
            else:
                wc_lanes = wc
            lanes = compare_lanes(wc_lanes, wp, fc, fp, m)
            outside = [j for j, lane in enumerate(lanes) if not lane[0]]
            inner_c, inner_p = int(np.sum(wc["nit_internal"])), int(np.sum(wp["nit_internal"]))
            bad = (
                len(outside) > BATCH_OUTLIERS * BATCH_STARTS
                or (full and not np.array_equal(fc["status"], fp["status"]))
                or abs(inner_c - inner_p) > 0.25 * inner_p
            )
            one = singles[(p.name, v)]
            msg = (
                f"phase 12a [{card}]: {p.name} / {v} (m={m}), {BATCH_STARTS} starts: window "
                f"({WINDOW} iterations) card {wc['wall']:.3f} s, CPU {wp['wall']:.3f} s; inner "
                f"count {inner_c} card, {inner_p} CPU, equal in "
                f"{int(np.sum(wc['nit_internal'] == wp['nit_internal']))} lanes; lanes outside "
                f"phase 10's classes {len(outside)}"
            )
            if full:
                msg += (
                    f"; to the end: card {fc['wall']:.3f} s, CPU {fp['wall']:.3f} s (statuses "
                    f"{np.bincount(fc['status'], minlength=3).tolist()}, equal card and CPU: "
                    f"{np.array_equal(fc['status'], fp['status'])}, nit mean "
                    f"{float(np.mean(fc['nit'])):.1f} max {int(np.max(fc['nit']))}); one start "
                    f"alone (phase 10): card {one['cuda'][0]:.3f} s, CPU {one['cpu'][0]:.3f} s, "
                    f"{BATCH_STARTS} of them one by one on one CPU core ~"
                    f"{BATCH_STARTS * one['cpu'][0]:.1f} s"
                )
            log(msg)
            for j in outside:
                log(
                    f"phase 12a:   lane {j}: window nit {wc['nit'][j]}/{wp['nit'][j]} inner "
                    f"{wc['nit_internal'][j]}/{wp['nit_internal'][j]} x deviation "
                    f"{lanes[j][1]!r}"
                    + (f"; end status {fc['status'][j]}/{fp['status'][j]} nit "
                       f"{fc['nit'][j]}/{fp['nit'][j]} fun deviation {lanes[j][2]!r}" if full else "")
                )
            if bad:
                failures.append(f"{p.name} / {v}: lanes outside {outside}, inner {inner_c}/{inner_p}")
    for f in failures:
        log(f"phase 12a: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 12a: {len(failures)} batches differ card against CPU")


def phase12b(card: str, dev) -> None:
    """The 1k-lambda elastic-net sweep through ``make_lasso_lambda_sweep``."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    A_np, b_np = make_problem(*SWEEP_SHAPE)
    A, b = torch.as_tensor(A_np, device=dev), torch.as_tensor(b_np, device=dev)
    lams = np.logspace(-4, 0, SWEEP_LAMBDAS).astype(np.float32)
    lr = 1.0 / Lasso(A, b, 1.0, l2_ratio=SWEEP_MU).lipschitz()
    fns = make_lasso_lambda_sweep(A, b, l2_ratio=SWEEP_MU)
    x0s = torch.zeros((SWEEP_LAMBDAS, SWEEP_SHAPE[1]), dtype=torch.float32, device=dev)
    kw = dict(batch_params=torch.as_tensor(lams, device=dev), lr=lr, decay_rate=1, nesterov=True)
    minimize_proximal_gradient_batch(*fns, x0s, max_iter=2, **kw)  # first-use costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = minimize_proximal_gradient_batch(*fns, x0s, max_iter=HARNESS_MAX_ITER, **kw)
    wall = time.perf_counter() - t0
    log(
        f"phase 12b [{card}]: {SWEEP_LAMBDAS}-lambda elastic-net sweep (A {SWEEP_SHAPE[0]}x"
        f"{SWEEP_SHAPE[1]} f32, lambda 1e-4..1, mu {SWEEP_MU}, fixed step lr 1/L = {lr!r}): "
        f"converged {float(np.mean(res.status == 1))!r}, nit mean {float(np.mean(res.nit))!r} "
        f"max {int(np.max(res.nit))}, wall {wall:.3f} s, {SWEEP_LAMBDAS / wall:.1f} solves/s"
    )
    if not (np.all(np.isfinite(res.x)) and np.all(res.status == 1)):
        raise AssertionError("phase 12b: the sweep did not converge everywhere")
    worst = 0.0
    for j in np.linspace(0, SWEEP_LAMBDAS - 1, SWEEP_CHECK).astype(int):
        one = Lasso(A, b, float(lams[j]), l2_ratio=SWEEP_MU).solve_fixed_step(
            torch.zeros(SWEEP_SHAPE[1], dtype=torch.float32, device=dev), lr=lr,
            max_iter=HARNESS_MAX_ITER,
        )
        d = float(np.linalg.norm(res.x[j] - one.x) / max(np.linalg.norm(one.x), 1.0))
        worst = max(worst, d)
        if one.status != 1 or not d <= SWEEP_RTOL:
            raise AssertionError(f"phase 12b: lane {j} differs from its single solve by {d!r}")
    log(
        f"phase 12b: {SWEEP_CHECK} lanes against single Lasso(..., l2_ratio={SWEEP_MU})."
        f"solve_fixed_step solves on the card: largest relative difference {worst!r} "
        f"(bound {SWEEP_RTOL})"
    )


def phase12c(card: str, dev) -> None:
    """JOS1 n=50 from ``JOS1_LANES`` starts in float32: every converged
    lane on the Pareto set, the segment x = c 1, c in [0, 2]."""
    from zfista_tpu_torch.models import JOS1

    p = JOS1(n_features=50)
    x0s = np.random.default_rng(42).uniform(-2.0, 4.0, size=(JOS1_LANES, 50)).astype(np.float32)
    x0s = torch.as_tensor(x0s, device=dev)
    p.solve_batch(x0s[:16], nesterov=True, max_iter=2)  # first-use costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = p.solve_batch(x0s, nesterov=True, tol=1e-5)
    wall = time.perf_counter() - t0
    ok = res.status == 1
    # On the Pareto set (x = c 1, c in [0, 2]) sqrt(F1) + sqrt(F2) = 2, and
    # off it larger: the gap measures each lane's distance to the front.
    gap = np.abs(np.sqrt(res.fun[:, 0]) + np.sqrt(res.fun[:, 1]) - 2)
    log(
        f"phase 12c [{card}]: JOS1 n=50 from {JOS1_LANES} starts, f32, nesterov, tol 1e-5: "
        f"converged {float(np.mean(ok))!r}, nit mean {float(np.mean(res.nit))!r} max "
        f"{int(np.max(res.nit))}, wall {wall:.3f} s, {JOS1_LANES / wall:.1f} solves/s; largest "
        f"gap to the Pareto front {float(np.max(gap))!r} (bound 1e-3), largest spread of an x "
        f"{float(np.max(np.ptp(res.x, axis=1)))!r}"
    )
    if not (ok.mean() >= 0.99 and np.max(gap) <= 1e-3 and np.all(res.x >= -0.05)
            and np.all(res.x <= 2.05)):
        raise AssertionError("phase 12c: JOS1 lanes off the Pareto set or not converged")


def phase12d(card: str, dev, wide: dict) -> None:
    """FDS n=10 from ``FDS_LANES`` starts (run to the end in the pool), and
    ``lane_chunk=FDS_CHUNK`` bitwise equal to the unchunked batch over
    ``CHUNK_ITERS`` iterations (every State field)."""
    from zfista_tpu_torch.models import FDS

    counts = np.bincount(wide["status"], minlength=3).tolist()
    log(
        f"phase 12d [{card}]: FDS n=10 from {FDS_LANES} starts, f64, accelerated: statuses "
        f"{counts}, converged {float(np.mean(wide['status'] == 1))!r}, nit mean "
        f"{float(np.mean(wide['nit']))!r} max {int(np.max(wide['nit']))}, wall "
        f"{wide['wall']:.3f} s (inside the pool of phases 10 and 12)"
    )
    if counts[1] < 0.99 * FDS_LANES or not np.all(np.isfinite(wide["x"])):
        raise AssertionError("phase 12d: the FDS batch did not converge")
    x0s = np.random.default_rng(42).uniform(-2.0, 2.0, size=(FDS_LANES, 10))
    kw = dict(nesterov=True, tol_internal=HARNESS_TOL_INTERNAL, max_iter=CHUNK_ITERS)
    walls = {}
    runs = {}
    for chunk in (None, FDS_CHUNK):
        t0 = time.perf_counter()
        runs[chunk] = FDS(n_features=10).solve_batch(torch.tensor(x0s, device=dev), lane_chunk=chunk, **kw)
        walls[chunk] = time.perf_counter() - t0
    same = all(np.array_equal(a, c) for a, c in zip(runs[None].state, runs[FDS_CHUNK].state))
    log(
        f"phase 12d [{card}]: {CHUNK_ITERS} iterations, unchunked {walls[None]:.3f} s, "
        f"lane_chunk={FDS_CHUNK} {walls[FDS_CHUNK]:.3f} s; bitwise equal (every State field): {same}"
    )
    if not same:
        raise AssertionError("phase 12d: lane_chunk changes the result")


def phase12e(card: str, dev) -> None:
    """Host reads and device events per outer iteration of a JOS1 (m=2) and
    an FDS (m=3) batch at each of ``COUNT_WIDTHS`` lanes: the same 16
    starts tiled, so every width runs the same rounds of every loop.  Per
    iteration is the difference between a run of ``2 * COUNT_ITERS`` and
    one of ``COUNT_ITERS`` iterations, over ``COUNT_ITERS``: the set-up and
    the result's host copy cancel."""
    from zfista_tpu_torch.models import FDS, JOS1

    for name, p, low, high in (("JOS1 n=50", JOS1(n_features=50), -2.0, 4.0),
                               ("FDS n=10", FDS(n_features=10), -2.0, 2.0)):
        base = torch.tensor(np.random.default_rng(42).uniform(low, high, (16, p.n_features)), device=dev)
        seen = {}
        for B in COUNT_WIDTHS:
            x0s = base.repeat(B // 16, 1)
            got = {}
            for its in (COUNT_ITERS, 2 * COUNT_ITERS):
                run = lambda: p.solve_batch(x0s, nesterov=True, tol=0, max_iter=its)
                got[its] = (count_host_reads(run)[1], *device_events(run, by_name=True))
            (r1, e1, b1, n1), (r2, e2, b2, n2) = got[COUNT_ITERS], got[2 * COUNT_ITERS]
            names = {k: n2.get(k, 0) - n1.get(k, 0) for k in set(n1) | set(n2)}
            seen[B] = (r2 - r1, e2 - e1, names)
            log(
                f"phase 12e [{card}]: {name}, {B} lanes: host reads {(r2 - r1) / COUNT_ITERS!r} "
                f"and device events {(e2 - e1) / COUNT_ITERS!r} per outer iteration, device "
                f"busy {(b2 - b1) / COUNT_ITERS:.1f} us per iteration"
            )
        (ra, ea, na), (rb, eb, nb) = (seen[B] for B in COUNT_WIDTHS)
        if (ra, ea) != (rb, eb):
            diff = {k: (na.get(k, 0), nb.get(k, 0)) for k in set(na) | set(nb) if na.get(k, 0) != nb.get(k, 0)}
            log(f"phase 12e: {name}: events that differ by width (over {COUNT_ITERS} iterations): {diff}")
        # Flat in the lane count: FDS's counts came out 0.3-0.8% apart at 16
        # and 1,024 lanes (cause not identified), JOS1's equal.
        if abs(ra - rb) > COUNT_RTOL * max(ra, rb) or abs(ea - eb) > COUNT_RTOL * max(ea, eb):
            raise AssertionError(f"phase 12e: {name}'s counts depend on the width")


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
        f"phase 1 [{smi}]: built {[p.name for p in paths]} in "
        f"{time.perf_counter() - t0:.3f} s (in parallel)"
    )

    # -- phase 2: the fused LASSO kernel vs its plain versions on the card -----
    lasso_err = phase2(dev)

    # -- phase 3: the dense step at the full problem size --------------------
    A_np, b_np = make_problem()
    A = torch.as_tensor(A_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    prob = Lasso(A, b, LAM)
    L = prob.lipschitz()
    lr = torch.tensor(1.0 / L, dtype=torch.float32, device=dev)
    lam = torch.tensor(LAM, dtype=torch.float32, device=dev)
    zeros_n = torch.zeros(N, dtype=torch.float32, device=dev)
    carry = (zeros_n, zeros_n, torch.tensor(1.0, device=dev))
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
    lasso_launches = {}
    zero(fused.launch_counts)  # the main-path solve starts here
    res = Lasso(A, b, LAM).solve_fixed_step(x0, tol=0, max_iter=4000)
    torch.cuda.synchronize()
    launched = dict(fused.launch_counts)  # ... and ends here
    lasso_launches["lasso_step_tail"] = launched["lasso_step_tail"]
    log(
        f"phase 4: Lasso.solve_fixed_step(tol=0, max_iter=4000): nit={res.nit} "
        f"status={res.status} fun={float(res.fun[0])!r} lr={res.lr!r} "
        f"kernel launches={launched}"
    )
    if res.nit != 4000 or not np.all(np.isfinite(res.x)) or res.x.shape != (N,):
        raise AssertionError("slice run: wrong nit or non-finite x")
    if launched["lasso_step_tail"] < 4000:
        raise AssertionError(f"slice run launched the kernels {launched}")

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

    # With tol_rel the step keeps its tail in eager launches around the
    # kernel's first entry (prox + extrapolation): the same iterates, bitwise.
    zero(fused.launch_counts)
    routed = Lasso(A, b, LAM).solve_fixed_step(
        x0, lr=res.lr, tol=0, tol_rel=1e-30, max_iter=AGREE_ITERS
    )
    launched = dict(fused.launch_counts)
    lasso_launches["fused_prox_momentum"] = launched["fused_prox_momentum"]
    log(
        f"phase 4: the same {AGREE_ITERS} iterations with tol_rel=1e-30 (the tail in eager "
        f"launches): nit={routed.nit}, kernel launches={launched}; x, t, err bitwise "
        f"equal to the fused tail's: "
        f"{all(np.array_equal(a, c) for a, c in zip(routed.state, short.state))}"
    )
    if launched["fused_prox_momentum"] < AGREE_ITERS or launched["lasso_step_tail"]:
        raise AssertionError(f"tol_rel solve launched {launched}")
    for name, a, c in zip(routed.state._fields, routed.state, short.state):
        if not np.array_equal(a, c):
            raise AssertionError(f"tol_rel solve differs from the fused tail in State.{name}")

    conv = {}
    for ce in (None, 1, 64):
        t0 = time.perf_counter()
        conv[ce] = Lasso(A, b, LAM).solve_fixed_step(x0, lr=res.lr, check_every=ce)
        log(
            f"phase 4 [{smi}]: default-tol solve, check_every={ce}: status={conv[ce].status} "
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
    zero(fused.launch_counts)  # the raw loop's first run is its main-path run
    for fn in runs.values():  # warm-up: cuBLAS handles, allocator pools
        fn()
    torch.cuda.synchronize()
    lasso_launches["fista_tail"] = fused.launch_counts["fista_tail"]
    if lasso_launches["fista_tail"] != iters:
        raise AssertionError(f"the raw fused loop launched {dict(fused.launch_counts)}")
    rates: dict[str, list[float]] = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs)), list(runs)):
        for k in order:
            rates[k].append(iters / sync_time(runs[k]))
    for k, v in rates.items():
        med = statistics.median(v)
        log(
            f"phase 5 [{smi}]: {k}: {med:.1f} iter/s median of {[round(r, 1) for r in v]}; "
            f"{med * BYTES_PER_ITER / 1e9:.1f} GB/s against "
            f"{BYTES_PER_ITER / 1e6:.0f} MB/iter"
        )

    kern_ms: dict[str, dict[int, tuple[float, float]]] = {k: {} for k in LASSO_KERNELS}
    for n in (N, 10_000_000):
        y, g, x = (torch.randn(n, device=dev) for _ in range(3))
        tail_kw = step_tail_cases(y, g, x, torch.float32, dev)["active"]
        scal = {
            "fused_prox_momentum": [torch.tensor(v, device=dev) for v in (0.1, 0.05, 0.3)],
            "fista_tail": [torch.tensor(v, device=dev) for v in (3.7, 0.1, 0.5)],
        }
        calls = {
            "fused_prox_momentum": (
                lambda: fused.fused_prox_momentum(y, g, x, *scal["fused_prox_momentum"]),
                lambda: fused.fused_prox_momentum_plain(y, g, x, *scal["fused_prox_momentum"]),
            ),
            "fista_tail": (
                lambda: fused.fista_tail(y, g, x, *scal["fista_tail"]),
                lambda: fused.fista_tail_plain(y, g, x, *scal["fista_tail"]),
            ),
            "lasso_step_tail": (
                lambda: fused.lasso_step_tail(**tail_kw),
                lambda: fused.lasso_step_tail_plain(**tail_kw),
            ),
        }
        reps = 500 if n == N else 100
        for name, (kernel, plain) in calls.items():
            k_ms = event_ms(kernel, reps)
            p_ms = event_ms(plain, reps)
            kern_ms[name][n] = (k_ms, p_ms)
            log(
                f"phase 5 [{smi}]: {name} f32 n={n}: kernel {k_ms * 1e3:.2f} us per call back "
                f"to back ({20 * n / (k_ms * 1e-3) / 1e9:.1f} GB/s at 20 B/elem), "
                f"plain {p_ms * 1e3:.2f} us (host-bound at n={N})"
            )

    t0 = time.perf_counter()
    tv_err = phase6(dev)
    log(f"phase 6 [{smi}]: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tv_launches, tv_runs = phase7(dev, smi)
    log(f"phase 7 [{smi}]: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tv_ms = phase8(dev, smi)
    log(f"phase 8 [{smi}]: done in {time.perf_counter() - t0:.1f} s")

    # -- phases 9-12: the multiobjective solve with backtracking, the batch ----
    # Phase 10's solves and phase 12's harness batches share one pool of
    # worker processes; the batches timed in this process (12b, 12c) run
    # before the first profiled region (timings after one come out slower).
    pooled: dict = {}
    walls: dict = {}
    for n_phase, run in (
        ("12b", lambda: phase12b(smi, dev)),
        ("12c", lambda: phase12c(smi, dev)),
        (9, lambda: phase9(dev, smi, A, b, A_np, b_np, res.lr)),
        # Phase 5's profile, here because timings taken after a profiled
        # region in the same process come out slower, and phase 9 profiles.
        (5, lambda: lasso_loops(dev, smi)),
        ("10 and 12's pool", lambda: pooled.update(
            run_pool(smi, dev, phase10_tasks(dev) + phase12_tasks(dev))
        )),
        (10, lambda: walls.update(phase10(smi, dev, pooled))),
        ("12a", lambda: phase12a(smi, dev, pooled, walls)),
        (11, lambda: phase11(smi, dev)),
        ("12d", lambda: phase12d(smi, dev, pooled[("fds_wide", str(dev))])),
        ("12e", lambda: phase12e(smi, dev)),
    ):
        t0 = time.perf_counter()
        run()
        log(f"phase {n_phase} [{smi}]: done in {time.perf_counter() - t0:.1f} s")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": lasso_launches[name],
            "max_abs_err": max(lasso_err[name], step_err if name == "fista_tail" else 0.0),
            "ms": kern_ms[name][N][0],
            "plain_ms": kern_ms[name][N][1],
            # y, g, x read and x, y written once, float32 (the 0-d scalars
            # and flags add under 100 bytes).
            "bound_ms": 1e3 * 5 * N * 4 / PEAK_BYTES_PER_S,
            "bound_by": "bytes",
            # No single PyTorch call computes the soft-threshold and the
            # momentum step together, let alone the step's tail.
            "library_ms": None,
        }
        for name, replaces in LASSO_KERNELS.items()
    ]
    for name, (source, replaces) in TV_KERNELS.items():
        # Each kernel's time at the size and n_iter its main-path run used.
        n, n_iter = tv_runs[name]
        b_ms, b_by = fgp_bound((n, n), torch.float32, n_iter)
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": tv_launches[name],
                "max_abs_err": tv_err[name],
                "n_iter": n_iter,
                "ms": tv_ms[n, n_iter][name],
                "plain_ms": tv_ms[n, n_iter]["fgp_plain"],
                "bound_ms": b_ms,
                "bound_by": b_by,
                # No PyTorch call computes an FGP iteration.
                "library_ms": None,
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
