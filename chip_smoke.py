"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases 1-5,14a   # some phases (names, numbers, ranges)

A subset runs what its phases need of the others (the build, the LASSO
problem and its ``lr``, the pool's tasks), checks what those phases check,
and prints the same lines at the end; its ``kernels`` line lists the
kernels its phases ran, with null for what they did not measure.

The fixed-step solves of phases 4, 5, 7, 11b, 13d, 14a and 14c,
``solve_warm`` in phase 7, the backtracking solves of phases 9, 11, 14c
and 14d (their line search as carried steps: a trial a step at m <= 2, a
Newton iteration of the current trial at m >= 3), phase 10's m >= 3
solves at ``check_every=8``, the fixed-lr batch of phase 12b, the
backtracking batch of 12c (one trial in every lane a step) and the FDS
batches of 12d and 12e (one Newton iteration in every lane a step) run
their chunks as replayed CUDA graphs
(``zfista_tpu_torch.core.solver.run_graphed``): each is held bitwise
against its ``check_every=1`` run, its captures and replays are counted,
and phase 4's launch count is held against the profiler's count of the
step-tail kernel.  The history drivers (phase 11's ``return_all``, 12a's
``benchmark()`` batches and m >= 3 windows, 12e's counted batches and
12f's m = 1 LASSO ``return_all`` solves and sweep) replay graphs of a few
steps (``run_recorded``), each held bitwise against the eager per-step
driver.  ``--phases 7,11`` runs the graphed TV and m = 2 checks,
``--phases 9,11,12b,14c,14d`` the graphed backtracking and batch ones,
``--phases 11,12a,12c,12e,12f`` the batch search and the history graphs,
``--phases 10,11,12a,12d,12e`` the m >= 3 ones.

Drives the port's three slices on the card and checks every CUDA kernel
of them against its plain PyTorch version:

* dense LASSO (m=2000, n=10,000, float32, lambda=0.01, the recipe of
  bench.py) solved by fixed-step FISTA through
  ``zfista_tpu_torch.models.Lasso.solve_fixed_step`` (phases 2-5; 5b
  holds its gradient's single-pass kernel, ``lasso_normal_gemv``, to
  float64 and to itself);
* TV-regularized deblurring (``examples/tv_deblur.py``'s workload: the
  synthetic cameraman at 256x256, Gaussian 9x9 sigma=4, noise 1e-3,
  tv_ratio 2e-4) through ``zfista_tpu_torch.models.TVDeblur``, whose TV
  prox runs the FGP kernels (phases 6-8);
* the single solve with backtracking and several objectives (phases
  9-11): the LASSO above by ``Lasso.solve``, and the benchmark harness's
  15 zoo problems (``zfista_tpu/bench/harness.py``) through
  ``Problem.solve``;
* the batch solver (phase 12): the harness's problems through the port's
  ``bench.harness.benchmark``, the 1k-lambda elastic-net sweep through
  ``make_lasso_lambda_sweep``, and wide JOS1 and FDS batches.  Phases 9-12
  add no CUDA kernel: cuBLAS products and small elementwise launches;
* the experiment layer (phase 13): the harness's metrics and CLI, the
  papers' momentum sweeps, the wall-to-gap and restart benches (which run
  the fused LASSO kernel and the whole-image FGP kernel), checkpoint,
  profiling and the native metrics;
* the models left (phase 14): wavelet-L1 deblurring of the cameraman
  (``WaveletDeblur``, whose fixed-step solve runs the fused LASSO kernel's
  step tail), its 15-pair momentum sweep by the port's example script,
  sparse logistic regression and group LASSO, and the two kernel benches;
* scale-out (phase 15): the n = 10^6 dense LASSO of
  ``zfista_tpu_torch.examples.large_lasso`` (A 8 GB float32, the fused
  raw step's tail ``fista_tail`` once per step), a world of one NCCL rank,
  two ranks sharing the card over Gloo (the feature-sharded ``Lasso`` runs
  the kernel's ``fused_prox_momentum`` once per step), the weak-scaling
  bench's one-card row, and feature-sharded zoo solves with two and three
  objectives (the m = 2 bisection's and the m >= 3 Newton dual's sums over
  features all-reduced; no kernel);
* the two-axis ``("batch", "model")`` mesh (phase 16): lane batches on a
  feature-sharded operator over four ranks sharing the card, and
  ``GroupLasso`` on feature blocks.  It adds no kernel: the batch step
  bypasses the fused LASSO kernel.

Phases:

1. the card (``nvidia-smi``) and the kernels' build from ``csrc/``, one
   ``nvcc`` per source, all started together;
2. the fused LASSO kernel's three entries (prox + momentum, the raw step's
   tail, the solver's step tail) against their plain versions, bitwise,
   float32 and float64, n from 1 to 10^7 (the LASSO and logistic paths'
   10^4, the wavelet path's 65,536, phase 15c's per-rank 5,000 and phase
   15a's 10^6 among them), on active, converging, stopped and NaN-carrying
   states;
3. one dense FISTA step, fused against plain, at the full problem size;
4. the LASSO slice through the public entry point: launch counts (the
   step tail once per step run, replays counted; after phase 9, against
   torch.profiler's count of the kernel over ten replays), agreement with
   a float64 numpy FISTA loop, the routed ``tol_rel`` solve bitwise equal
   to the fused tail's, convergence, and the graphed chunks
   (``check_every`` 64 and auto) bitwise equal to per-step checking;
5. the card's own times of the LASSO slice and of its kernel's entries at
   n = 10^4, 65,536, 10^6 and 10^7 in float32 and 5,000 in float64
   (``bench._card.held_ms``: the calls queued
   behind a stream hold long enough for the host to queue them all), and
   (run after phase 9) device events and busy time per iteration of
   the public path with eager chunks and with graphs, and of the raw
   loops, by torch.profiler, with the capture's cost;
6. the three FGP kernels against the plain loop, bitwise, from 1x105 to
   2048x2048 (the tile windows' edges in float32 and float64; float64 at
   256x256 through the whole-image kernel and at 600x520), both
   discretizations, cold and warm duals; serial and pipelined tiles
   bitwise equal; the dual-gap certificate;
7. the TV slice through the public entry points: a 500-iteration
   ``TVDeblur.solve`` (launch counts, its chunks replayed graphs),
   agreement with a float64 plain-loop solve, PSNR, ``check_every`` 64
   (one capture, the replays) and the main-path run bitwise
   ``check_every=1``, ms a step on the cached graph, with eager chunks and
   on a first solve, in turns, with the capture's ms; and ``solve_warm``
   at 256x256, at 2048x2048 and (pipelined tiles pinned) at 768x768 on
   tv_bench's scene, graphed, bitwise its ``check_every=1`` and its
   plain-prox runs, ms a step graphed against eager chunks, the card's
   SM clock and power draw beside them; (after phase 9) device events,
   busy µs and busy share a step of each graphed solve by torch.profiler,
   its replays alone by CUDA events, and each FGP kernel's µs a call
   inside the graph;
8. the card's own times: each FGP kernel, the plain loop and the bound per
   prox call from 256x256 to 2048x2048 at 30 and 8 dual iterations, one
   tile sweep per round of tiles, and the TV solves' wall time, kernel
   against plain;
9. backtracking LASSO at full width (``decay_rate=0.5``, ``lr=1``), its
   line search as carried trials on replayed graphs at ``check_every`` 64
   and 16, bitwise the default ``check_every=1`` solve (captures and
   replays counted), first solves at 64 and 16 against the default in
   turns with the captures' ms; nit, trials per iteration, iter/s on the
   cached graph, with eager chunks, at ``check_every=1`` and by the fixed
   step, host reads per iteration (below 0.1 graphed), device busy share;
   float64 on the card against float64 on the CPU (50 iterations: same
   inner count, 1e-9 relative), float32 against float64 (200 iterations,
   1e-4);
10. the harness's 15 problems under every variant (plus the projected one
    for bounded problems), the first start of ``benchmark()``'s draw
    (one start per case, to leave phase 12 the time), float64, each solve
    on the card against the same solve on the CPU: a 12-iteration window
    (equal nit; equal nit_internal for m<=2, within 25% for m>=3; x within
    1e-8 for m<=2 and 1e-6 for m>=3) and the full solve (equal status, fun
    within 1e-6 relative), and each m>=3 full solve on the card again at
    ``check_every=8`` (carried Newton steps on replayed graphs, one capture,
    replays counted) bitwise its ``check_every=1`` solve; run in worker
    processes, one CPU thread each;
11. ``check_every=8``, ``iter_chunk=5`` and ``return_all`` solves on the
    card, bitwise equal to the ``check_every=1`` solve, for JOS1 with L1
    (``check_every=8`` and ``return_all`` on replayed graphs, counted, the
    history bitwise the eager per-step driver's, walls beside) and for FDS
    (``check_every=8`` as carried Newton steps and ``return_all`` on
    replayed graphs, counted);
    (b) JOS1 n=50 at m = 2 by the fixed step in float64, at
    ``check_every`` 8 and 64 on replayed graphs, bitwise ``check_every=1``,
    ms a step graphed against eager chunks;
12. the batch solver: (a) every phase-10 case as one batch of
    ``benchmark()``'s 100 starts (``history=True``), card against CPU lane
    by lane in phase 10's classes (all statuses equal, at most 10% of the
    lanes outside the classes: rounding-floor flips; m>=3 inner counts per
    batch), over the window and, for m<=2, to the end, with walls beside
    phase 10's single solves; the m<=2 card batches to the end on replayed
    history graphs (one capture a first solve, replays counted), and over
    the window graphed bitwise the eager per-step history (State,
    allfuns, allerrs, history_mask), first-solve walls graphed and eager
    in turns, host reads per history row (the per-step twin cut to the
    window: to the end it took minutes of the pool's time); the m>=3 card
    batches over the window on the graphed history
    (carried Newton steps), bitwise the eager per-step history and timed
    against it as first solves in turns (the per-step twin cut to the
    window: to the end it runs for minutes); (b) the 1k-lambda
    elastic-net sweep (A 500 x 2000, float32, fixed step), converged share,
    mean nit and solves/s, at ``check_every=8`` on replayed graphs bitwise
    the ``check_every=1`` sweep (a first and a repeat sweep, walls beside),
    its lanes 0-15 and 505-520 (across the edge of the first two GEMM
    blocks) each as a batch of 16 bitwise the same lanes among all 1,000
    (the shared operator's products run in GEMMs of a fixed number of
    lanes, ``ops/precision.py``), 8 lanes against single ``Lasso`` solves
    within 1e-5; (c) JOS1 n=50 from 10,000 starts in float32, on the Pareto front,
    and at ``check_every=8`` (per-lane carried trials on replayed graphs)
    bitwise the ``check_every=1`` batch, a first and a repeat timed beside;
    (d) FDS n=10 from 1,024 starts in float64 at ``check_every=8`` (every
    lane one Newton iteration of its own trial a step, on replayed graphs;
    first and repeat), its first 64 lanes bitwise the round-based batch of
    those starts, and ``lane_chunk=256`` bitwise equal to the unchunked
    batch; (e) host reads and device events per outer iteration at 16 and
    1,024 lanes, within 1%, JOS1's with ``history=True`` on its cached
    history graphs and FDS's at ``check_every=8`` on its cached graphs
    (9 and 18 iterations); (f) the m = 1 history
    drivers at full width (the LASSO's ``return_all`` by the fixed step
    and by backtracking, the 1k-lambda sweep with ``history=True``), each a
    first solve on replayed history graphs bitwise the eager per-step
    driver, walls in turns and host reads per row; (g) the 25 cells that
    only the ``--large`` sweep runs (JOS1 at n = 10 ... 1000 and FDS at
    n = 5 ... 100, plain, L1 and bounded; ZDT1 at n = 100), at their own
    sizes through ``benchmark()``'s batch as in (a), the first
    ``LARGE_STARTS`` of its 100 starts, card against CPU lane by lane over
    the window for every cell and variant and to the end for m <= 2, ZDT1
    n = 100's lanes 3-7 alone on the card bitwise the same lanes among 8,
    and the m >= 3 accelerated variants to the end on the card, every lane
    converged (its CPU batches in a second pool of worker processes beside
    phases 10-12d).  Phases 10, 12 and 13's harness work shares one pool
    of worker processes.
13. the experiment layer: (a) the metrics of 12a's to-the-end batches
    (m<=2 cells) card against CPU (Error rate equal, Hypervolume within
    1e-3, Avg iterations within 5%) and the performance profiles; (b) the
    harness CLI over the 15 cells twice on one ``--out`` (the second run
    all cache hits, byte-identical metrics.json); (c) the momentum sweeps
    of examples/data/{JOS1,SD}_ab.csv (1,000 starts, float64), every
    pair's error rate 0 and mean nit within 2% of the CSV; (d) wall to a
    1e-6 and a 1e-8 optimality gap on the headline LASSO
    (``gap_bench.run()``); (e) ``restart_bench`` (LASSO and TV rows);
    (f) checkpoint resume bitwise, batched states, TV metadata, a trace
    with an annotation and the step-tail kernel; (g) the native metrics
    against their numpy paths.
14. the models left: (a) the cameraman (examples/cameraman_deblur.py's
    recipe, 256x256 float32) by ``WaveletDeblur.solve()``: one
    ``lasso_step_tail`` launch per step run, ``check_every`` 8 and 64
    (replayed graphs), a repeat on the cached graph and eager chunks
    bitwise equal to 1, against the float64 CPU solve (F within 1e-4,
    PSNR within 0.05 dB, the first 200 iterations within 1e-4, nit within
    25% of it and of examples/data/cameraman_ab.csv: the count is set at
    the rounding floor), launches per step by torch.profiler (eager and
    graphed); (b) the
    15-pair sweep by ``python -m zfista_tpu_torch.examples.cameraman_deblur``
    (every pair converged, each lane's F within 1e-4 of (a)'s float64 CPU
    solve, each nit within 25% of the CSV and their mean within 6%,
    seconds per pair), and the same 15 lanes over their first 200
    iterations, each within 1e-4 of its pair's float64 CPU solve;
    (c) ``SparseLogistic`` (2,000 x 10,000, float32): the backtracking
    default within KKT 2e-4 (its float32 line search shrinks lr), with
    the float32 accept slack and the fixed step within KKT 1e-4, both
    backtracking solves at ``check_every=64`` on replayed graphs bitwise
    ``check_every=1``, each F
    within 1e-4 of the float64 CPU solve's, the fixed step one
    ``lasso_step_tail`` launch per step (replayed graphs, bitwise its
    ``check_every=1`` solve), 50-iteration windows float32
    against float64 (1e-4) and float64 card against CPU (equal counts,
    1e-9); (d) ``GroupLasso`` on the LASSO problem above, groups of 10:
    float32 converges to 1e-6 with and without the accept slack (each at
    ``check_every=64`` on replayed graphs bitwise ``check_every=1``), each F
    within 1e-4 of the float64 CPU solve's, float64 card against CPU as
    (c); (e)
    ``bench.kernels`` and ``bench.tv_bench`` (256² and 2048²), their kernel
    against plain checks bitwise.  The CPU references and the sweep run in
    the pool of phases 10, 12 and 13.
15. scale-out, after the rest: (a) ``large_lasso`` at m=2,000, n=10^6,
    float32, 200 steps, in this process (``fista_tail`` once per step of
    its warm-up and timed runs), iter/s and GB/s beside a ``copy_`` rate
    measured in the same run and the bound (A read twice per step: 4.78
    ms); the same 200 steps fused against plain bitwise, and F within 1e-4
    of the same steps in float64 on the card; (b) an NCCL world of one rank:
    the headline LASSO through ``Lasso`` on ``distribute_global(A, mesh,
    P(None, "model"))`` to convergence, nit and x bitwise the unsharded
    solve, ``fused_prox_momentum`` once per step run and never
    ``lasso_step_tail``; a 16-lane lambda sweep with ``in_sharding``
    bitwise the unsharded sweep; (c) two spawned processes sharing the card
    over Gloo (NCCL refuses two ranks on one device; Gloo takes CUDA
    tensors in all-reduce, the port's only collective), float64: the
    headline LASSO feature-sharded over ``model=2``, equal nit and x within
    1e-9 of the unsharded card solve, ``fused_prox_momentum`` once per
    step run on each rank, and the sweep's lanes over ``batch=2`` bitwise
    the unsharded sweep in every field; (d)
    ``bench.scaling.weak_scaling((1,), device="cuda")`` at its defaults;
    (e) feature-sharded solves with two and three objectives, float64,
    zoo problems built with ``sharding=feature_sharding(mesh)``: an NCCL
    world of one rank (JOS1 at n = 10^6, 50 fixed steps at 1/L; FDS at
    n = 10^5, 10 fixed steps at ``check_every=1``), each bitwise the
    unsharded card solve in every State field; two Gloo ranks sharing the
    card (those two and JOS1 by backtracking, 10 iterations): equal nit,
    x within 1e-8 (m = 2) and 1e-6 (m = 3) of the unsharded card solve,
    both ranks' x bitwise equal; a 1x2 batch of JOS1 (64 lanes, n = 10^4,
    15 fixed steps) on the two ranks, each lane in the m = 2 class of the
    unsharded card batch; walls and all-reduces per outer iteration
    beside, and no fused-kernel launch.
16. the two-axis mesh, four spawned processes sharing the card over
    Gloo: (a) the headline LASSO in float64 (A cast) as a 16-lane lambda
    sweep, geometric 0.005-0.05, backtracking from 1/L, its first 100
    iterations, on 2 (batch) x 2 (model) ranks (blocks 2,000 x 5,000, 8
    lanes a rank): every field of every lane bitwise the 1x2 (model-only)
    batch of the same lanes, and against the unsharded batch equal status
    and nit per lane, x within 1e-12;
    (b) the same problem in float32, 64 lanes, 100 fixed steps at 1/L on
    the 2x2 mesh: lane-iterations/s, exactly one all-reduce per product
    and one max per step for all of a rank's lanes, F per lane within
    1e-4 of the float64 batch; (c) ``GroupLasso`` in float64 on two ranks'
    blocks of 5,000 (each row of the mesh, one group size), backtracking
    as 14d over its first 300 iterations, groups of 10 (aligned) and 16
    (one group straddles the blocks): equal status, nit and x within
    1e-12 of the unsharded solve, the
    aligned prox bitwise the unsharded prox, and the group sweep's lanes
    bitwise among 16 or 8; (d) the parity worker (``python -m
    zfista_tpu_torch.parallel.distributed``) as four CUDA ranks over Gloo,
    beside (a)-(c)'s unsharded references: its ``PARITY_OK``,
    ``TP_PARITY_OK`` and ``MESH2D_PARITY_OK`` lines.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is not 0.  Without a CUDA device it exits at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

M, N, LAM = 2000, 10_000, 0.01
#: Bytes of HBM one FISTA iteration reads: A (80 MB in float32) twice,
#: once per matvec (it exceeds the 50 MB L2), in the raw dense steps; once
#: through the single-pass gradient of the public solve.  The n-vectors add
#: <1 MB.
BYTES_PER_ITER = 2 * M * N * 4
KERNEL_SOURCE = "zfista_tpu_torch/csrc/fused_prox_momentum.cu"
#: The fused LASSO kernel's entries (zfista_tpu_torch.ops.fused wrappers):
#: the TPU function each replaces.
LASSO_KERNELS = {
    "fused_prox_momentum": "zfista_tpu/ops/fused.py:62",
    "fista_tail": "zfista_tpu/ops/fused.py:144",
    "lasso_step_tail": "zfista_tpu/ops/fused.py:62",
}
#: Phase 14a-b: the cameraman's side; the wavelet solve's step tail runs at
#: n = WL_SIDE**2.
WL_SIDE = 256
#: Phase 15: the large LASSO's width (large_lasso's default), its rows, its
#: steps, and the ranks that share the card over Gloo in 15c.
LARGE_N, LARGE_M, LARGE_ITERS, GLOO_RANKS = 1_000_000, 2000, 200, 2
#: Phase 2: vector lengths (edge cases, the LASSO and logistic paths' n, one
#: past it, the wavelet path's n, a rank's block of the LASSO in phase 15c,
#: the large LASSO's n and 10^7, past the L2).
FUSED_CHECK_SIZES = (1, 1000, N, 10_001, WL_SIDE**2, N // GLOO_RANKS, LARGE_N, 10_000_000)
#: Phase 5: the kernel entries' timed sizes (n, dtype): every main path's.
KERNEL_TIME_SIZES = (
    (N, torch.float32), (WL_SIDE**2, torch.float32), (LARGE_N, torch.float32),
    (10_000_000, torch.float32), (N // GLOO_RANKS, torch.float64),
)
#: First iterations of the slice compared with the float64 numpy loop, and
#: the bound on their relative 2-norm difference: float32 rounding
#: (eps 6e-8) amplified over 200 momentum steps.
AGREE_ITERS, AGREE_RTOL = 200, 1e-4
SOURCES = ("fused_prox_momentum", "lasso_normal_gemv", "fgp_resident", "fgp_tiles")
#: Phase 5b: the single-pass gradient's shapes (m, n): the main path's,
#: ragged rows and columns, one column, one row, the kernel's row budget
#: (``fused.NORMAL_GEMV_MAX_N``), and a row under four floats; each with A
#: aligned and with A 4 bytes past an aligned address (rows off 16-byte
#: boundaries: the kernel's one-float loads).
GEMV_CHECK_SHAPES = ((M, N), (1999, 10_001), (M, 1), (1, N), (7, 12_288), (300, 3))
GEMV_SOURCE = "zfista_tpu_torch/csrc/lasso_normal_gemv.cu"
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


def event_ms(fn, reps: int, device_bound: bool = True) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls back to
    back, by ``bench._card.held_ms``: the stream is held while the host
    queues the calls, so a call that costs the host more than its kernel
    costs the card is still timed on the card (``held_ms`` lengthens the
    hold until the host has queued them all in time, or raises).  A plain
    version's window (``device_bound=False``) is timed at the slower of
    the two rates."""
    from zfista_tpu_torch.bench._card import held_ms

    return held_ms(lambda: [fn() for _ in range(reps)], device_bound=device_bound) / reps


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


def chain_ms(fn, v0, lam, n_iter: int, calls: int = 20, device_bound: bool = True) -> float:
    """Device ms per prox call over ``calls`` chained calls (each call's u
    is the next call's v), by ``bench._card.held_ms`` (a stream hold while
    the host queues the chain, CUDA events).  The plain loop's chain
    (``device_bound=False``: more launches than the launch queue holds) is
    timed at the host's rate."""
    from zfista_tpu_torch.bench._card import held_ms

    z = torch.zeros_like(v0)

    def chain():
        v = v0
        for _ in range(calls):
            v = fn(lam, v, z, z, n_iter)[0]

    return held_ms(chain, device_bound=device_bound) / calls


def fgp_times(dev, side: int, n_iter: int, names) -> dict[str, list[float]]:
    """Device ms per prox call of each FGP kernel in ``names`` on a
    ``side`` x ``side`` float32 image (numpy seed 8, lam 0.05, zero duals),
    timed in turns: each name in order, then in reverse.  It drives only
    the wrappers ``fgp_resident`` and ``fgp_tiles`` of the
    ``zfista_tpu_torch`` it imports (and its ``bench._card`` timer), so run
    from the root of another tree of the repository that has
    ``bench/_card.py``, with this file copied there, it times that tree's
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
    ``reps`` launches behind a stream hold (``bench._card.held_ms``); every launch reads the same
    buffers, so it times whatever the entry does with them."""
    import ctypes

    from zfista_tpu_torch.bench._card import held_ms
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds = -(-tv_cuda.n_tiles((side, side), torch.float32, pipelined) // sms)
    return held_ms(lambda: [launch() for _ in range(reps)]) / reps, rounds


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
            want = {"fused_prox_momentum": 1, "fista_tail": 1, "lasso_step_tail": len(cases),
                    "lasso_normal_gemv": 0}
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


def zero(counts: dict[str, int]) -> None:
    for name in counts:
        counts[name] = 0


def graph_counts() -> dict[str, int]:
    """The solver's chunk-graph counters now (``solver.graph_counts``: the
    graphs captured and replayed since import, and the captures' steps,
    nodes and host ns)."""
    from zfista_tpu_torch.core import solver

    return dict(solver.graph_counts)


def graph_replays() -> int:
    """Chunk-graph replays the solver has launched since import."""
    return graph_counts()["replays"]


def graphs_since(before: dict[str, int]) -> dict[str, int]:
    """Captures and replays since ``before`` (a :func:`graph_counts`)."""
    now = graph_counts()
    return {k: now[k] - before[k] for k in ("captures", "replays")}


def last_capture_ms(before: dict[str, int]) -> float:
    """The host ms of the chunk-graph captures since ``before`` (a
    :func:`graph_counts`): their recording and instantiation, from the
    solver's capture timers (the eager first chunk before each is apart)."""
    now = graph_counts()
    return 1e-6 * sum(now[k] - before[k] for k in ("record_ns", "instantiate_ns"))


@contextlib.contextmanager
def warm_check_every(n: int):
    """``solve_warm``'s driver at ``check_every=n`` (on a card it takes 64
    and replays its chunks as graphs; 1 is one host read per step)."""
    from zfista_tpu_torch.models import deblur as td

    real = td._tv_warm_driver
    td._tv_warm_driver = partial(real, check_every=n)
    try:
        yield
    finally:
        td._tv_warm_driver = real


def same_warm(a: dict, b: dict) -> bool:
    """Two ``solve_warm`` results equal bit for bit (x, F, nit, err)."""
    return (
        np.array_equal(a["x"], b["x"])
        and (a["fun"], a["nit"], a["error_criterion"]) == (b["fun"], b["nit"], b["error_criterion"])
    )


def in_turns(runs: dict, order: tuple[str, ...]) -> dict[str, list[float]]:
    """Seconds of each of ``runs`` (name -> callable, a synchronized wall
    each), called in ``order``."""
    walls: dict[str, list[float]] = {k: [] for k in runs}
    for k in order:
        walls[k].append(sync_time(runs[k]))
    return walls


def card_state() -> str:
    """The card's SM clock and power draw now, as ``nvidia-smi`` reads
    them, to stand beside a timing (a card below its maximum clock runs a
    device-bound step slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def steps_run(nit: int, chunk: int = 64) -> int:
    """Steps a run of ``nit`` iterations takes in chunks of ``chunk``: the
    frozen steps of the last chunk run too."""
    return -(-nit // chunk) * chunk


def per_step(walls: list[float], steps: int) -> list[float]:
    return [round(1e3 * w / steps, 4) for w in walls]


def cameraman_observed(dev) -> tuple[np.ndarray, np.ndarray]:
    """``examples/tv_deblur.py``'s cameraman at ``CAMERAMAN``: the truth and
    the blurred image with numpy-seeded noise 1e-3."""
    from zfista_tpu_torch.models import deblur as td

    truth_t = td.synthetic_cameraman(CAMERAMAN, dtype=torch.float64, device=dev)
    observed = td.make_blur(td.gaussian_kernel())(truth_t).cpu().numpy()
    observed = observed + 1e-3 * np.random.default_rng(0).standard_normal(observed.shape)
    return truth_t.cpu().numpy(), observed


def warm_scenes(dev) -> list[tuple]:
    """Phase 7's ``solve_warm`` runs: (side, kernel, observed, tv_ratio,
    prox_method), the cameraman and tv_bench's scenes."""
    from zfista_tpu_torch.bench import tv_bench
    from zfista_tpu_torch.models import deblur as td

    _, observed = cameraman_observed(dev)
    scenes = [(CAMERAMAN, td.gaussian_kernel(), observed, 2e-4, "auto")]
    return scenes + [(n, *tv_bench.scene(n, dev), 1e-3, m) for n, m in TV_BENCH_RUNS]


def phase7(dev, card: str) -> tuple[dict[str, int], dict[str, tuple[int, int]], dict]:
    """The TV slice through the public entry points.  Each FGP kernel's
    main-path run is the first run below that goes through it: the
    500-iteration ``solve`` (the whole-image kernel at 256x256) and the
    ``solve_warm`` runs on tv_bench's scene (the serial tiles by ``auto``
    at 2048x2048, the pipelined tiles pinned at 768x768).  Every
    count is set to 0 just before each run and read just after.  The
    fixed-step chunks of both solves are replayed CUDA graphs: each is
    held bitwise against its ``check_every=1`` run, its captures and
    replays counted, and timed per step against eager chunks and a first
    solve, in turns.  Returns each kernel's launches in its main-path run,
    that run's image side and dual iterations per prox call, and the walls
    per step of the graphed runs (for phase 7's profile)."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.ops import tv_cuda

    counts = tv_cuda.launch_counts
    truth, observed = cameraman_observed(dev)
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
    before = graph_counts()
    zero(counts)  # the main-path solve starts here
    t0 = time.perf_counter()
    res = quiet(prob.solve, max_iter=500, tol=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(counts)  # ... and ends here
    graphs = graphs_since(before)
    log(
        f"phase 7 [{card}]: TVDeblur(cameraman {CAMERAMAN}x{CAMERAMAN} f32, tv_ratio 2e-4, "
        "prox_iter 30)"
        f".solve(max_iter=500, tol=0): nit={res.nit} status={res.status} "
        f"fun={float(np.ravel(res.fun)[0])!r} lr={res.lr!r} wall {wall:.3f} s (with the "
        f"capture, {last_capture_ms(before):.1f} ms); prox_kernel {meta['prox_kernel']}; kernel "
        f"launches {launched}; chunk graphs {graphs}"
    )
    if res.nit != 500 or res.x.shape != (CAMERAMAN**2,) or not np.all(np.isfinite(res.x)):
        raise AssertionError("TV slice run: wrong nit or non-finite x")
    kern = kinds[meta["prox_kernel"]]
    if launched[kern] < 500:
        raise AssertionError(f"TV slice run launched the kernels {launched}")
    if graphs != {"captures": 1, "replays": -(-500 // 64) - 1}:
        raise AssertionError(f"TV slice run: chunk graphs {graphs}")
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
        before = graph_counts()
        t0 = time.perf_counter()
        conv[ce] = quiet(TVDeblur(b32, **kw).solve, lr=lr, check_every=ce, max_iter=3000)
        graphs = graphs_since(before)
        log(
            f"phase 7 [{card}]: default-tol solve, check_every={ce}: status={conv[ce].status} "
            f"nit={conv[ce].nit} err={conv[ce].error_criterion!r} "
            f"wall {time.perf_counter() - t0:.3f} s; chunk graphs {graphs}"
        )
        want = {"captures": 0, "replays": 0} if ce == 1 else {
            "captures": 1, "replays": -(-conv[ce].nit // ce) - 1}
        if graphs != want:
            raise AssertionError(f"default-tol solve, check_every={ce}: chunk graphs {graphs}")
    same_state(conv[64].state, conv[1].state, "TV check_every=64 (replayed graphs) against 1")
    same_state(res.state, quiet(TVDeblur(b32, **kw).solve, lr=lr, max_iter=500, tol=0,
                                check_every=1).state,
               "TV main-path run (replayed graphs) against check_every=1")
    log("phase 7: check_every=64 (one capture, replays) and the graphed main-path run are "
        "bitwise equal to check_every=1 in every State field")

    # Per step: the cached graph (a repeat solve), eager chunks (the driver
    # before the graphs) and a first solve (a fresh instance: one eager
    # chunk, the capture, the replays), in turns.
    steps, capture = 500, []

    def first():
        before = graph_counts()
        quiet(TVDeblur(b32, **kw).solve, lr=lr, max_iter=steps, tol=0)
        capture.append(last_capture_ms(before))

    def eager():
        with eager_chunks():
            quiet(prob.solve, lr=lr, max_iter=steps, tol=0)

    clocks = card_state()
    walls = in_turns(
        {"graph": lambda: quiet(prob.solve, lr=lr, max_iter=steps, tol=0), "eager": eager,
         "first": first},
        ("graph", "eager", "first"),
    )
    run = steps_run(steps)
    step_ms = {"solve": min(walls["graph"]) * 1e3 / run}
    log(
        f"phase 7 [{card}]: TVDeblur.solve {CAMERAMAN}x{CAMERAMAN} f32, {steps} iterations "
        f"({run} steps run), ms a step in turns: cached graph {per_step(walls['graph'], run)}, "
        f"eager chunks {per_step(walls['eager'], run)}, first solve (eager chunk, capture, "
        f"replays) {per_step(walls['first'], run)}; the capture alone {[round(c, 1) for c in capture]} "
        f"ms of host time; SM clock, power draw before and after: {clocks!r}, {card_state()!r}"
    )

    for size, kernel, obs, tv_ratio, method in warm_scenes(dev):
        b = torch.tensor(obs, dtype=torch.float32, device=dev)
        prob = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method=method)
        kind = prob.checkpoint_meta()["prox_kernel"]
        warm = dict(max_iter=200, tol=0, prox_iter=8)
        before = graph_counts()
        zero(counts)
        t0 = time.perf_counter()
        w = prob.solve_warm(**warm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(counts)
        graphs = graphs_since(before)
        capture_ms = last_capture_ms(before)
        with warm_check_every(1):
            w1 = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method=method).solve_warm(**warm)
        wp = TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method="xla").solve_warm(**warm)
        same, same1 = np.array_equal(w["x"], wp["x"]), same_warm(w, w1)
        log(
            f"phase 7 [{card}]: solve_warm(max_iter=200, prox_iter=8) at {size}x{size} f32: "
            f"prox_method {method!r} runs {kind}; nit={w['nit']} fun={w['fun']!r} "
            f"wall {wall:.3f} s (with the capture, {capture_ms:.1f} ms); "
            f"launches {used}; chunk graphs {graphs}; == check_every=1 bitwise (x, F, nit, "
            f"err): {same1}; == plain-prox solve_warm bitwise: {same}"
        )
        if w["nit"] != 200 or not np.all(np.isfinite(w["x"])) or not same or not same1:
            raise AssertionError(
                f"solve_warm at {size}: wrong nit, non-finite or != check_every=1 or plain")
        if used[kinds[kind]] < 200:
            raise AssertionError(f"solve_warm at {size} launched {used}")
        if graphs != {"captures": 1, "replays": -(-200 // 64) - 1}:
            raise AssertionError(f"solve_warm at {size}: chunk graphs {graphs}")
        if kinds[kind] not in runs:
            main_launches[kinds[kind]] = used[kinds[kind]]
            runs[kinds[kind]] = (size, 8)

        def eager_warm(prob=prob, warm=warm):
            with eager_chunks():
                return prob.solve_warm(**warm)

        before = graph_counts()
        repeats = {"graph": lambda prob=prob, warm=warm: prob.solve_warm(**warm), "eager": eager_warm}
        clocks = card_state()
        walls = in_turns(repeats, ("graph", "eager", "eager", "graph"))
        again = graphs_since(before)
        run = steps_run(200)
        step_ms[f"warm {size}"] = min(walls["graph"]) * 1e3 / run
        log(
            f"phase 7 [{card}]: solve_warm at {size}x{size}, 200 iterations ({run} steps run), "
            f"ms a step in turns: cached graph {per_step(walls['graph'], run)}, eager chunks "
            f"{per_step(walls['eager'], run)}; "
            f"the repeats' chunk graphs {again}; SM clock, power draw before and after: "
            f"{clocks!r}, {card_state()!r}"
        )
        if again["captures"]:
            raise AssertionError(f"solve_warm at {size}: a repeat solve captured again")

    for name in TV_KERNELS:
        if not main_launches.get(name):
            raise AssertionError(f"the TV slice never launched {name}")
    log(f"phase 7: main-path launches {main_launches} at (image side, n_iter) {runs}")
    return main_launches, runs, step_ms


def replay_step_ms(chunk: int = 64, replays: int = 5) -> float:
    """Device ms a step of the most recent chunk graph (of ``chunk`` steps),
    by CUDA events around ``replays`` replays back to back, with no host
    read between them (they rerun the chunk on its static buffers, which
    the next solve overwrites)."""
    from zfista_tpu_torch.core import solver

    graph = next(reversed(solver._GRAPHS.values())).graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * chunk)


def phase7_profile(card: str, dev, step_ms: dict) -> dict[str, float]:
    """The graphed TV solves under torch.profiler, each on its cached graph
    (captured outside the profile), 640 steps (ten replays): device events
    and busy µs a step, the share of phase 7's wall a step that is busy,
    the device ms a step of the graph's replays alone (CUDA events), and
    each FGP kernel's µs a call inside the graph.  Run after phase 9
    (timings taken after a profiled region come out slower).  Returns the
    kernels' µs a call inside the graphs."""
    from zfista_tpu_torch.models import TVDeblur

    _, observed = cameraman_observed(dev)
    b32 = torch.tensor(observed, dtype=torch.float32, device=dev)
    steps = 640
    solves = {"solve": (TVDeblur(b32, tv_ratio=2e-4, prox_iter=30), None)}
    for size, kernel, obs, tv_ratio, method in warm_scenes(dev):
        b = torch.tensor(obs, dtype=torch.float32, device=dev)
        solves[f"warm {size}"] = (
            TVDeblur(b, tv_ratio=tv_ratio, kernel=kernel, prox_method=method), 8)
    names = {"fgp_bands_kernel": "fgp_resident", "fgp_tiles_serial_kernel": "fgp_tiles",
             "fgp_tiles_pipelined_kernel": "fgp_tiles_pipelined"}
    kernel_us: dict[str, float] = {}
    for what, (prob, prox_iter) in solves.items():
        if prox_iter is None:
            run = lambda prob=prob: quiet(prob.solve, max_iter=steps, tol=0)  # noqa: E731
        else:
            run = lambda prob=prob: prob.solve_warm(max_iter=steps, tol=0, prox_iter=8)  # noqa: E731
        run()  # the capture, outside the profile
        replay_ms, clocks = replay_step_ms(), card_state()
        before = graph_counts()
        n_events, busy, by_name = device_events(run, by_name=True, times=True)
        graphs = graphs_since(before)
        calls = {}
        for key, (count, us) in by_name.items():
            for kname, name in names.items():
                if kname in key:
                    c, t = calls.get(name, (0, 0.0))
                    calls[name] = (c + count, t + us)
        share = busy / steps / (1e3 * step_ms[what])
        log(
            f"phase 7 [{card}]: {what} on its cached graph, {steps} steps ({graphs}): "
            f"{n_events / steps:.2f} device events and {busy / steps:.1f} us busy a step; busy "
            f"share of phase 7's {step_ms[what]:.4f} ms a step: {share:.3f}; the cached graph's "
            f"replays alone {replay_ms:.4f} ms a step by CUDA events; FGP kernels inside "
            f"the graph: " + ", ".join(f"{k} {c} calls, {t / c:.2f} us each" for k, (c, t) in calls.items())
            + f"; SM clock, power draw {clocks!r}"
        )
        if graphs != {"captures": 0, "replays": steps // 64} or not calls:
            raise AssertionError(f"phase 7 profile, {what}: graphs {graphs}, kernels {calls}")
        for name, (c, t) in calls.items():
            kernel_us.setdefault(name, t / c)
    return kernel_us


def phase8(dev, card: str) -> dict[tuple[int, int], dict[str, float]]:
    """The card's times of the TV slice.  Returns device ms per prox call by
    (image side, n_iter) and implementation: each FGP kernel (the
    whole-image kernel where its bands fit), the plain loop, and the
    bound."""
    from zfista_tpu_torch.models import TVDeblur
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
            plain = chain_ms(tv_cuda.fgp_plain, v0, lam, n_iter, calls=5, device_bound=False)
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

    _, observed = cameraman_observed(dev)
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


def device_events(fn, by_name: bool = False, times: bool = False) -> tuple:
    """``fn()``'s device events by torch.profiler: how many there were
    (kernel launches and copies) and the sum of their own time in µs (one
    stream, no overlap), as the profiler table's "Self CUDA time total"
    sums them; with ``by_name`` also the count of each event's name (with
    ``times``, the count and the µs).  The host is traced too: tracing the
    device alone lost events of a long run on the H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    if not on_device:
        raise AssertionError("device_events: the profiler saw no device event")
    out = (
        sum(e.count for e in on_device),
        float(sum(e.self_device_time_total for e in on_device)),
    )
    if by_name:
        out += ({
            e.key: (e.count, float(e.self_device_time_total)) if times else e.count
            for e in on_device
        },)
    return out


@contextlib.contextmanager
def eager_chunks():
    """Chunks launched eagerly on the card, as before the graphed driver
    (for the times beside the graphs; a tree without the graphed driver
    runs so anyway)."""
    from zfista_tpu_torch.core import solver

    real = getattr(solver, "_graphs_run_on", None)
    if real is not None:
        solver._graphs_run_on = lambda device: False
    try:
        yield
    finally:
        if real is not None:
            solver._graphs_run_on = real


@contextlib.contextmanager
def two_products():
    """The LASSO gradient by its two cuBLAS products, as a feature-sharded
    operator's column block computes it, where a whole operator would take
    the single-pass kernel."""
    from zfista_tpu_torch.models import lasso

    real = lasso._one_pass
    lasso._one_pass = lambda A, b, x: False
    try:
        yield
    finally:
        lasso._one_pass = real


def lasso_loops(dev, card: str, iters: int = 256) -> dict[str, dict[str, float]]:
    """Per iteration of the fixed-step LASSO slice (the module's problem at
    full width): wall µs without the profiler (three runs in turns, the
    least), then device events and their busy µs with it, for the public
    path (``Lasso.solve_fixed_step``, tol 0, ``iters`` iterations) with its
    chunks launched eagerly ("public") and replayed as CUDA graphs
    ("public (graph)", a repeat solve on the cached graph), and the raw
    loops over the fused and the plain dense step; then the capture's ms
    and a first solve (a fresh ``Lasso``: one eager chunk, the capture,
    the replays) against a repeat solve, in turns.  It drives the port's
    public functions (and the solver's switch between graphed and eager
    chunks, where the tree has one), so run from the root of another tree
    of the repository with this file copied there, it measures that
    tree."""
    from zfista_tpu_torch.core import solver
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

    def public():
        return quiet(prob.solve_fixed_step, x0, lr=lr_f, tol=0, max_iter=iters)

    def public_eager():
        with eager_chunks():
            return public()

    graphs = hasattr(solver, "run_graphed")
    runs = {"public": public_eager if graphs else public}
    if graphs:
        runs["public (graph)"] = public
    runs.update(raw_fused=raw(fused.fista_step_dense_fused), raw_plain=raw(fista_step_dense))
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
    if graphs:
        # A cache miss: a fresh Lasso (new params) runs one chunk eagerly,
        # captures it and replays the rest; a repeat solve only replays.
        first: list[float] = []
        repeat: list[float] = []
        capture: list[float] = []
        for k in ("first", "repeat", "repeat", "first"):
            if k == "first":
                fresh = Lasso(A, b, LAM)
                before = graph_counts()
                first.append(1e3 * sync_time(
                    lambda: quiet(fresh.solve_fixed_step, x0, lr=lr_f, tol=0, max_iter=iters)))
                capture.append(last_capture_ms(before))
            else:
                repeat.append(1e3 * sync_time(public))
        out["capture"] = {"capture_ms": min(capture), "first_ms": min(first), "repeat_ms": min(repeat)}
        log(
            f"lasso loops [{card}]: public (graph), {iters} iterations: a first solve (fresh "
            f"Lasso: one eager chunk, the capture, the replays) {[round(v, 3) for v in first]} ms, "
            f"a repeat solve {[round(v, 3) for v in repeat]} ms, in turns; the capture alone "
            f"{[round(v, 3) for v in capture]} ms of host time"
        )
    return out


def same_result(got, ref, what: str) -> None:
    """Raise unless ``got`` is ``ref`` bit for bit: every State field, nit,
    nit_internal and status."""
    same_state(got.state, ref.state, what)
    if (got.nit, got.nit_internal, got.status) != (ref.nit, ref.nit_internal, ref.status):
        raise AssertionError(f"{what}: nit, nit_internal or status differ")


def trial_graphs_ok(graphs: dict[str, int], res, chunk: int) -> bool:
    """Whether an m = 1 backtracking solve ran all its trials (one inner
    iteration each, so ``nit_internal`` of them) as chunk graphs: one eager
    chunk and a capture then replays, or replays alone on a cached graph."""
    chunks = -(-res.nit_internal // chunk)
    return graphs["captures"] <= 1 and graphs["captures"] + graphs["replays"] == chunks


def held_at_64(card: str, what: str, solve, **kw):
    """``solve(check_every=64, **kw)`` (an m = 1 backtracking solve: its
    carried trials on replayed graphs) bitwise ``solve(check_every=1,
    **kw)``, its chunk graphs counted and both walls logged.  Returns the
    ``check_every=1`` result."""
    before = graph_counts()
    t0 = time.perf_counter()
    got = solve(check_every=64, **kw)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    graphs = graphs_since(before)
    t0 = time.perf_counter()
    ref = solve(check_every=1, **kw)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    same_result(got, ref, f"{what} at check_every=64 against check_every=1")
    if not trial_graphs_ok(graphs, got, 64):
        raise AssertionError(f"{what}: {got.nit_internal} trials ran chunk graphs {graphs}")
    log(
        f"{what} [{card}]: check_every=64 (chunk graphs {graphs}) bitwise check_every=1 in every "
        f"State field, nit {got.nit}, nit_internal {got.nit_internal} and status {got.status}; "
        f"wall {wall64:.3f} s against check_every=1's {wall1:.3f} s"
    )
    return ref


#: Phase 9: iterations of the timed runs, and the bound of a one-trial
#: backtracking iteration: A read four times (f(y), jac_f(y)'s two
#: products, f of the trial) at the card's memory rate.
BT_ITERS = 500
BT_BOUND_US = 1e6 * 4 * M * N * 4 / PEAK_BYTES_PER_S


def phase9(dev, card: str, A, b, A_np, b_np, lr_fixed: float) -> dict:
    """Backtracking LASSO at full width: ``Lasso.solve`` with the default
    ``decay_rate=0.5`` and ``lr=1``.  At ``check_every=64`` its line search
    runs as carried trials whose chunks are replayed CUDA graphs, bitwise
    the default ``check_every=1`` solve (a host read per trial): a first
    solve (a fresh ``Lasso``: one eager chunk, the capture, the replays)
    at 64 and at 16 against the default solve, in turns; then
    ``BT_ITERS`` iterations on the cached graph, with eager chunks, at
    ``check_every=1`` and by the fixed step: iter/s in turns, host reads
    per iteration, device events and busy share."""
    from zfista_tpu_torch.models import Lasso

    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    what = f"Lasso(m={M}, n={N}, f32, lambda={LAM}).solve(nesterov=True) (decay_rate 0.5, lr 1, tol 1e-5)"
    runs = {
        "first check_every=64": lambda: Lasso(A, b, LAM).solve(x0, nesterov=True, check_every=64),
        "default (check_every=1)": lambda: Lasso(A, b, LAM).solve(x0, nesterov=True),
        "first check_every=16": lambda: Lasso(A, b, LAM).solve(x0, nesterov=True, check_every=16),
    }
    walls: dict[str, list[float]] = {k: [] for k in runs}
    graphs: dict[str, list[dict]] = {k: [] for k in runs}
    capture: dict[str, list[float]] = {k: [] for k in runs}
    out: dict = {}
    for k in list(runs) + list(runs)[::-1]:
        before = graph_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[k] = runs[k]()
        torch.cuda.synchronize()
        walls[k].append(time.perf_counter() - t0)
        graphs[k].append(graphs_since(before))
        if graphs[k][-1]["captures"]:
            capture[k].append(last_capture_ms(before))
    ref = out["default (check_every=1)"]
    log(
        f"phase 9 [{card}]: {what}: status={ref.status} nit={ref.nit} "
        f"nit_internal={ref.nit_internal} trials/iteration={ref.nit_internal / ref.nit!r} "
        f"lr={ref.lr!r} fun={float(ref.fun[0])!r}; a first solve in turns, s: {walls} "
        f"(chunk graphs {graphs}; the captures' ms of host time {capture})"
    )
    if ref.status != 1 or not np.all(np.isfinite(ref.x)) or ref.x.shape != (N,):
        raise AssertionError("backtracking LASSO: no convergence or non-finite x")
    for k, chunk in (("first check_every=64", 64), ("first check_every=16", 16)):
        same_result(out[k], ref, f"phase 9: {k} against the default check_every=1")
        if any(g["captures"] != 1 or not trial_graphs_ok(g, ref, chunk) for g in graphs[k]):
            raise AssertionError(f"phase 9: {k} ran chunk graphs {graphs[k]}")
    if any(g != {"captures": 0, "replays": 0} for g in graphs["default (check_every=1)"]):
        raise AssertionError(f"phase 9: the default solve ran chunk graphs {graphs}")
    log(f"phase 9 [{card}]: check_every 64 and 16 (replayed graphs) are bitwise the default "
        f"check_every=1 solve in every State field, nit, nit_internal and status")

    # BT_ITERS iterations (tol 0) on one instance: the carried trials on
    # the cached graph, with eager chunks, check_every=1 and the fixed step.
    prob = Lasso(A, b, LAM)
    kw = dict(nesterov=True, tol=0, max_iter=BT_ITERS)

    def eager():
        with eager_chunks():
            return prob.solve(x0, check_every=64, **kw)

    # Unquieted: count_host_reads reads the sync warnings (status 0 warns
    # too, and is not counted).
    timed = {
        "graph": lambda: prob.solve(x0, check_every=64, **kw),
        "eager chunks": eager,
        "check_every=1": lambda: prob.solve(x0, check_every=1, **kw),
        "fixed_step": lambda: prob.solve_fixed_step(x0, lr=lr_fixed, tol=0, max_iter=BT_ITERS),
    }
    before = graph_counts()
    got = quiet(timed["graph"])
    graphs = graphs_since(before)
    same_result(got, quiet(timed["check_every=1"]), f"phase 9: {BT_ITERS} iterations at check_every=64")
    if graphs["captures"] != 1 or not trial_graphs_ok(graphs, got, 64):
        raise AssertionError(f"phase 9: {BT_ITERS} iterations ran chunk graphs {graphs}")
    for fn in timed.values():
        quiet(fn)
    rates: dict[str, list[float]] = {k: [] for k in timed}
    order = list(timed)
    for k in order + order[::-1]:
        rates[k].append(BT_ITERS / sync_time(lambda: quiet(timed[k])))
    reads, events, busy = {}, {}, {}
    for k, fn in timed.items():
        r, n_reads = count_host_reads(fn)
        reads[k] = n_reads / r.nit
    # The graphed paths only: eager chunks launch what the graph replays,
    # and the host loop's profile is the longest (the run's time limit).
    for k in ("graph", "fixed_step"):
        events[k], busy[k] = device_events(lambda: quiet(timed[k]))
    for k in timed:
        wall_us = 1e6 / statistics.mean(rates[k])
        profiled = (
            f"{events[k] / BT_ITERS:.2f} device events and {busy[k] / BT_ITERS:.1f} us busy an "
            f"iteration (torch.profiler), share of the unprofiled wall "
            f"{busy[k] / BT_ITERS / wall_us:.3f}" if k in busy else "not profiled"
        )
        log(
            f"phase 9 [{card}]: {k}, {BT_ITERS} iterations (tol 0; chunk graphs of the first "
            f"graph run {graphs}, {got.nit_internal} trials, bitwise check_every=1): "
            f"{[round(r, 1) for r in rates[k]]} iter/s (in turns); host reads/iteration "
            f"{reads[k]!r}; {profiled}; a one-trial iteration's bound {BT_BOUND_US:.1f} us (A "
            f"read four times)"
        )
    if not reads["graph"] < 0.1:
        raise AssertionError(f"phase 9: {reads['graph']!r} host reads per graphed iteration")

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
    return {"rates": rates, "reads": reads, "busy_us": busy, "first_s": walls, "capture_ms": capture}


#: Phase 10: the benchmark harness's problem list and variants, from the
#: port's harness (zfista_tpu_torch.bench.harness: initialize_problems(
#: large=False), _effective_variants).  Phase 10 solves one start per case
#: (the first of benchmark()'s draw), phase 12 batches benchmark()'s 100.
HARNESS_STARTS, HARNESS_TOL_INTERNAL, HARNESS_MAX_ITER, WINDOW = 1, 1e-11, 10_000, 12
BATCH_STARTS = 100
#: Worker processes for phases 10, 12 and 13 (at most the machine's cores less one).
PHASE10_WORKERS = 7


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
    """One task of the pool, in a worker process.  A phase-10 solve or
    phase-12 batch is ``(problem index, variant, start, device, window)``,
    with start ``None`` for the batch of all ``BATCH_STARTS`` starts.
    Starts are drawn as ``benchmark()`` draws them (numpy seed 42, the
    problem's sampling box); a single solve takes one row of that draw.  A
    batch to the end runs through the harness's own ``benchmark()`` (one
    variant, ``history=True``) and also returns its per-lane results; a
    window batch runs ``solve_batch`` (``benchmark()`` takes no ``tol``).
    Fields per lane: a single solve is one lane.  The other tasks: (d)'s
    wide FDS batch, 13b's CLI runs, 13c's momentum sweeps, 14b's cameraman
    sweep and 14a, c and d's CPU references."""
    if task[0] == "fds_wide":
        return fds_wide(task[1])
    if task[0] == "cli":
        return cli_runs(task[1])
    if task[0] == "sweep":
        return sweep_run(task[1], task[2])
    if task[0] == "cameraman_sweep":
        return cameraman_sweep(task[1])
    if task[0] == "wavelet_cpu":
        return wavelet_cpu()
    if task[0] == "wavelet_windows":
        return wavelet_windows()
    if task[0] == "model_cpu":
        return model_cpu(task[1])
    if task[0] == "windows":
        return model_windows(task[1], "cpu", torch.float64, task[2])
    if task[0] == "large":
        return large_solve(*task[1:])
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    i, variant, k, device, window = task
    problem, low, high = initialize_problems(large=False)[i]
    opts = _effective_variants(problem, None)[variant]
    if k is None and not window and device != "cpu" and problem.n_objectives <= 2:
        return history_turns(problem, low, high, variant, opts, device)
    t0 = time.perf_counter()
    if k is None and not window:
        lanes = benchmark_one(problem, low, high, variant, opts, device)
        return dict(
            nit=np.array([r.nit for r in lanes]),
            nit_internal=np.array([r.nit_internal for r in lanes]),
            status=np.array([r.status for r in lanes]),
            x=np.stack([r.x for r in lanes]),
            fun=np.stack([np.atleast_1d(r.fun) for r in lanes]),
            wall=time.perf_counter() - t0,
            results=lanes,
        )
    x0s = np.random.default_rng(42).uniform(low, high, size=(BATCH_STARTS, problem.n_features))
    kw = dict(tol_internal=HARNESS_TOL_INTERNAL, **opts)
    kw.update(dict(max_iter=WINDOW, tol=0) if window else dict(max_iter=HARNESS_MAX_ITER))
    if k is None and window and device != "cpu" and problem.n_objectives >= 3:
        return window_turns(problem, torch.tensor(x0s, device=device), kw)
    if k is None:
        res = problem.solve_batch(torch.tensor(x0s, device=device), history=True, **kw)
    else:
        res = problem.solve(torch.tensor(x0s[k], device=device), **kw)
    wall = time.perf_counter() - t0
    lanes = 1 if k is not None else BATCH_STARTS
    out = dict(
        nit=np.reshape(res.nit, lanes), nit_internal=np.reshape(res.nit_internal, lanes),
        status=np.reshape(res.status, lanes), x=np.reshape(res.x, (lanes, -1)),
        fun=np.reshape(res.fun, (lanes, -1)), wall=wall,
    )
    if k is not None and device != "cpu" and not window and problem.n_objectives >= 3:
        out["graphed"] = carried_newton_solve(problem, torch.tensor(x0s[k], device=device), kw, res)
    return out


def carried_newton_solve(problem, x0, kw: dict, ref) -> dict:
    """Phase 10's m >= 3 single solve on the card at ``check_every=8``: its
    carried Newton steps on replayed graphs (one capture, counted), every
    State field, nit and nit_internal bitwise the ``check_every=1`` solve
    ``ref``; its wall beside."""
    from zfista_tpu_torch.core import solver

    solver._GRAPHS.clear()
    before = graph_counts()
    t0 = time.perf_counter()
    got = problem.solve(x0, check_every=8, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = (got.nit, got.nit_internal) == (ref.nit, ref.nit_internal) and all(
        np.array_equal(a, c, equal_nan=True) and a.dtype == c.dtype
        for a, c in zip(got.state, ref.state)
    )
    capture = last_capture_ms(before) if solver._GRAPHS else float("nan")
    return dict(same=same, graphs=graphs_since(before), wall=wall, capture_ms=capture)


def history_same(got, ref) -> bool:
    """Two batches with history equal bit for bit: every State field and
    the four history arrays (NaN where both have it)."""
    keys = ("allfuns", "allerrs", "history_mask", "allvecs", "nit", "nit_internal", "status")
    return all(
        np.array_equal(a, c, equal_nan=a.dtype.kind == "f") and a.dtype == c.dtype
        for a, c in zip(got.state, ref.state)
    ) and all(
        (got.get(k) is None and ref.get(k) is None)
        or (got[k].dtype == ref[k].dtype
            and np.array_equal(got[k], ref[k], equal_nan=got[k].dtype.kind == "f"))
        for k in keys
    )


def history_turns(problem, low, high, variant: str, opts: dict, device: str) -> dict:
    """12a's m <= 2 batch to the end on the card, in a worker: the
    harness's ``benchmark()`` (one variant, ``history=True``) as a first
    solve through the graphed history driver (the graph cache emptied;
    captures and replays counted); then the same batch call over the
    ``WINDOW``'s first iterations graphed and eagerly (the per-step driver,
    ``eager_chunks``), each a first solve with its host reads counted, held
    bitwise (State and the four history arrays): walls in turns (graph,
    eager).  The per-step twin to the end took 305 s of the pool's worker
    time in all on the H100, so it is cut to the window, as the m >= 3 one."""
    from zfista_tpu_torch.bench import harness
    from zfista_tpu_torch.core import solver

    real = harness.minimize_proximal_gradient_batch
    kept: dict = {}

    def keep(*a, **kw):
        t0 = time.perf_counter()
        kept["res"] = real(*a, **kw)
        torch.cuda.synchronize()
        kept["wall"], kept["call"] = time.perf_counter() - t0, (a, kw)
        return kept["res"]

    def first(graphs: bool):
        """One first solve of the batch call over the window, timed:
        graphed from an empty cache, or eager."""
        a, kw = kept["call"]
        kw = dict(kw, max_iter=WINDOW)
        solver._GRAPHS.clear()
        ctx = contextlib.nullcontext() if graphs else eager_chunks()
        t0 = time.perf_counter()
        with ctx:
            res = real(*a, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    solver._GRAPHS.clear()
    harness.minimize_proximal_gradient_batch = keep
    before = graph_counts()
    t0 = time.perf_counter()
    try:
        lanes = benchmark_one(problem, low, high, variant, opts, device)
    finally:
        harness.minimize_proximal_gradient_batch = real
    wall = time.perf_counter() - t0
    graphs = graphs_since(before)
    (graphed, g_wall), g_reads = count_host_reads(lambda: first(True))
    (eager, e_wall), e_reads = count_host_reads(lambda: first(False))
    same = history_same(graphed, eager)
    rows = int(np.asarray(graphed.allfuns).shape[1])
    return dict(
        nit=np.array([r.nit for r in lanes]),
        nit_internal=np.array([r.nit_internal for r in lanes]),
        status=np.array([r.status for r in lanes]),
        x=np.stack([r.x for r in lanes]),
        fun=np.stack([np.atleast_1d(r.fun) for r in lanes]),
        wall=wall,
        results=lanes,
        turns=dict(
            steps=solver.HISTORY_GRAPH_STEPS.get(problem.n_objectives, 0), graphs=graphs,
            same=same, rows=rows, graph=[g_wall], eager=[e_wall], end=kept["wall"],
            reads={"graph": g_reads, "eager": e_reads},
        ),
    )


def window_turns(problem, x0s, kw: dict) -> dict:
    """12a's m >= 3 batch over the window on the card, in a worker, with
    history: a first solve on the graphed history (carried Newton steps,
    the graph cache emptied, captures and replays counted), the per-step
    history (``eager_chunks``), each with its host reads counted, held
    bitwise (State and the four history arrays): first-solve walls in
    turns (graph, eager).  The per-step history of such a
    batch to the end runs for minutes, so its twin is cut to the window."""
    from zfista_tpu_torch.core import solver

    def first(graphs: bool):
        solver._GRAPHS.clear()
        before = graph_counts()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if graphs else eager_chunks():
            res = problem.solve_batch(x0s, history=True, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, graphs_since(before)

    (graphed, g_wall, graphs), g_reads = count_host_reads(lambda: first(True))
    (eager, e_wall, _), e_reads = count_host_reads(lambda: first(False))
    same = history_same(graphed, eager)
    return dict(
        nit=np.asarray(graphed.nit), nit_internal=np.asarray(graphed.nit_internal),
        status=np.asarray(graphed.status), x=np.asarray(graphed.x), fun=np.asarray(graphed.fun),
        wall=g_wall,
        turns=dict(
            steps=solver.HISTORY_GRAPH_STEPS.get(problem.n_objectives, 0), graphs=graphs,
            same=same, rows=int(np.asarray(graphed.allfuns).shape[1]), graph=[g_wall],
            eager=[e_wall], reads={"graph": g_reads, "eager": e_reads},
        ),
    )


def benchmark_one(problem, low, high, variant: str, opts: dict, device: str) -> list:
    """One variant of the harness's ``benchmark()`` at 12a's settings."""
    from zfista_tpu_torch.bench.harness import benchmark

    return benchmark(
        problem, low, high, n_samples=BATCH_STARTS, max_iter=HARNESS_MAX_ITER,
        tol_internal=HARNESS_TOL_INTERNAL, history=True, variants={variant: opts},
        device=device,
    )[variant]


def run_pool(card: str, dev, tasks: list) -> dict:
    """Phases 10, 12 and 13's solves in worker processes, one CPU thread
    each: the solves are host-bound (hundreds of small launches per outer
    iteration).  The longest first (the cameraman sweep, the momentum
    sweeps, the CLI runs, the wide FDS batch, phase 14's CPU references,
    then batches, full solves, several objectives, on the
    card), so that no long one starts last."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from zfista_tpu_torch.bench.harness import initialize_problems

    problems = initialize_problems(large=False)
    large = initialize_problems(large=True)
    first = ("cameraman_sweep", "sweep", "cli", "fds_wide", "wavelet_cpu", "wavelet_windows",
             "model_cpu", "windows")

    def order(t):
        if t[0] in first:
            return (first.index(t[0]) - len(first), 0, 0, False)
        if t[0] == "large":  # 12g: the m >= 3 card batches to the end among the first
            return (-0.5, t[4], -large[t[1]][0].n_objectives, t[3] == "cpu")
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
        f"phases 10, 12 and 13 [{card}]: {len(tasks)} tasks in {workers} worker "
        f"processes: {time.perf_counter() - t0:.1f} s"
    )
    return results


#: Worker processes of 12g's CPU batches, which run beside the main
#: process's phases after the pool (host-bound on one core each).
BACKGROUND_WORKERS = 4


def start_background(tasks: list) -> tuple:
    """Start ``tasks`` (CPU only) in ``BACKGROUND_WORKERS`` worker processes,
    the longest first (the batches to the end, the widest problems), and
    return at once: ``(executor, futures, start)``."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from zfista_tpu_torch.bench.harness import initialize_problems

    large = initialize_problems(large=True)
    tasks = sorted(tasks, key=lambda t: (t[4], -large[t[1]][0].n_features))
    pool = ProcessPoolExecutor(BACKGROUND_WORKERS, mp_context=mp.get_context("spawn"),
                               initializer=_worker_init, initargs=("cpu",))
    return pool, {t: pool.submit(harness_solve, t) for t in tasks}, time.perf_counter()


def finish_background(card: str, started: tuple) -> dict:
    """The results of :func:`start_background`'s tasks, once all are done."""
    pool, futures, t0 = started
    try:
        results = {t: f.result() for t, f in futures.items()}
    finally:
        pool.shutdown()
    log(f"phase 12g [{card}]: {len(futures)} CPU tasks in {BACKGROUND_WORKERS} worker processes "
        f"beside phases 10-12d: done {time.perf_counter() - t0:.1f} s after their start")
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
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    return [
        (i, v, k, d, w)
        for i, (p, _, _) in enumerate(initialize_problems(large=False))
        for v in _effective_variants(p, None)
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
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    failures, inner = [], []
    walls: dict[tuple[str, str], dict[str, list[float]]] = {}
    problems = initialize_problems(large=False)
    for i, (p, _, _) in enumerate(problems):
        m = p.n_objectives
        dev_x = dev_fun = 0.0
        statuses = []
        for v in _effective_variants(p, None):
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
                g = fc.get("graphed")
                if m >= 3 and not (g and g["same"] and g["graphs"]["captures"] == 1
                                   and g["graphs"]["replays"] >= 1):
                    failures.append(f"{p.name} / {v} / start {k}: check_every=8 on the card: {g}")
                if g:
                    log(
                        f"phase 10 [{card}]: {p.name} / {v} / start {k}: check_every=8 (carried "
                        f"Newton steps, chunk graphs {g['graphs']}, capture {g['capture_ms']:.1f} "
                        f"ms) {g['wall']:.3f} s against check_every=1 {fc['wall']:.3f} s; bitwise "
                        f"check_every=1 (State, nit, nit_internal): {g['same']}"
                    )
                w = walls.setdefault((p.name, v), {"cuda": [], "cpu": [], "nit": []})
                w["cuda"].append(fc["wall"])
                w["cpu"].append(fp["wall"])
                w["nit"].append(int(fc["nit"][0]))
        per_p = [walls[(p.name, v)] for v in _effective_variants(p, None)]
        log(
            f"phase 10 [{card}]: {p.name} (m={m}): statuses {statuses}; largest deviation card "
            f"vs CPU: x {dev_x!r} over {WINDOW} iterations (bound {1e-8 if m <= 2 else 1e-6}), "
            f"fun {dev_fun!r} relative at the end (bound 1e-6); wall per full solve, median: "
            f"card {statistics.median(x for w in per_p for x in w['cuda']):.3f} s, CPU "
            f"{statistics.median(x for w in per_p for x in w['cpu']):.3f} s "
            f"(nit {[n for w in per_p for n in w['nit']]})"
        )
    cases = sum(len(_effective_variants(p, None)) for p, _, _ in problems) * HARNESS_STARTS
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
    and every State field; the history ends at the while driver's state.
    At m = 2 the ``return_all`` solve runs on replayed graphs, its
    ``allvecs``, ``allfuns`` and ``allerrs`` bitwise the eager per-step
    driver's."""
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.models import FDS, JOS1

    cases = [
        (JOS1(n_features=50, l1_ratios=[1.0 / 50, 2.0 / 50], l1_shifts=[0.0, -1.0]), -2.0, 4.0),
        (FDS(n_features=10), -2.0, 2.0),
    ]
    for p, low, high in cases:
        x0 = np.random.default_rng(42).uniform(low, high, size=(HARNESS_STARTS, p.n_features))[0]
        kw = dict(nesterov=True, tol_internal=HARNESS_TOL_INTERNAL, max_iter=HARNESS_MAX_ITER)
        runs, graphs = {}, {}
        for extra in ({"check_every": 1}, {"check_every": 8}, {"iter_chunk": 5}, {"return_all": True}):
            before = graph_counts()
            t0 = time.perf_counter()
            runs[str(extra)] = quiet(p.solve, torch.tensor(x0, device=dev), **kw, **extra)
            runs[str(extra)]["wall"] = time.perf_counter() - t0
            graphs[str(extra)] = graphs_since(before)
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
                with eager_chunks():
                    t0 = time.perf_counter()
                    eager = quiet(p.solve, torch.tensor(x0, device=dev), **kw, return_all=True)
                    e_wall = time.perf_counter() - t0
                same = same and all(
                    np.array_equal(np.asarray(u), np.asarray(v))
                    for u, v in ((r.allvecs, eager.allvecs), (r.allfuns, eager.allfuns),
                                 (r.allerrs, eager.allerrs))
                )
                steps = solver.HISTORY_GRAPH_STEPS.get(p.n_objectives, 0)
                log(f"phase 11 [{card}]: {p.name} return_all "
                    f"({f'replayed graphs of {steps} steps' if steps else 'the per-step driver'}) "
                    f"{r['wall']:.3f} s, the eager per-step history {e_wall:.3f} s; the histories "
                    f"bitwise equal: {same}")
            log(
                f"phase 11 [{card}]: {p.name} accelerated, {name}: status {r.status} nit {r.nit} "
                f"nit_internal {r.nit_internal} wall {r['wall']:.3f} s; chunk graphs {graphs[name]}; "
                f"bitwise equal to check_every=1 (x, nit, nit_internal, "
                f"State{', history' if 'return_all' in name else ''}): {same}"
            )
            if not same or r.status != 1:
                raise AssertionError(f"phase 11: {p.name} {name} differs from check_every=1")
            # The backtracking check_every=8 solve runs its carried steps
            # (a trial at m = 2, a Newton iteration at m = 3: at least one
            # a step) on replayed graphs, and so does the return_all solve
            # where the rule gives its m a history graph; iter_chunk and
            # check_every=1 stay eager.
            chunk = {"check_every': 8": 8,
                     "return_all": solver.HISTORY_GRAPH_STEPS.get(p.n_objectives, 0)}
            graphed = [c for k, c in chunk.items() if k in name and c]
            if graphed:
                if graphs[name]["captures"] != 1 or graphs[name]["replays"] < -(-r.nit // graphed[0]) - 1:
                    raise AssertionError(f"phase 11: {p.name} {name}: chunk graphs {graphs[name]}")
            elif graphs[name] != {"captures": 0, "replays": 0}:
                raise AssertionError(f"phase 11: {p.name} {name} ran chunk graphs {graphs[name]}")


#: Phase 11b: JOS1 at m = 2 by the fixed step in float64, phase 11's L1
#: terms: n, and the runs as (lr over 1/L, tol, max_iter).  At lr = 1/L the
#: solve converges in two steps, so that run goes to max_iter (tol 0); at
#: a tenth of it the solve stops by tol.  An eager step costs the host
#: ~25 ms on the card (~600 launches), so the fixed run is 100 steps.
JOS1_FIXED_N = 50
JOS1_FIXED_RUNS = ((1.0, 0.0, 100), (0.1, 1e-5, 1000))


def phase11b(card: str, dev) -> None:
    """JOS1 n=50 at m = 2 by the fixed step (``decay_rate=1``, Nesterov,
    float64): at ``check_every`` 8 and 64 the chunks are replayed CUDA
    graphs, every State field bitwise the ``check_every=1`` solve, one
    capture a first solve; then the wall a step on the cached graph
    against eager chunks, in turns."""
    from zfista_tpu_torch.models import JOS1

    n = JOS1_FIXED_N
    p = JOS1(n_features=n, l1_ratios=[1.0 / n, 2.0 / n], l1_shifts=[0.0, -1.0])
    x0 = torch.tensor(np.random.default_rng(42).uniform(-2.0, 4.0, size=n), device=dev)
    lip = 2.0 / n  # both objectives' Hessians are 2/n I
    for frac, tol, max_iter in JOS1_FIXED_RUNS:
        kw = dict(decay_rate=1, lr=frac / lip, nesterov=True, tol=tol, max_iter=max_iter,
                  tol_internal=HARNESS_TOL_INTERNAL)
        what = f"JOS1 n={n} m=2 fixed step lr={frac}/L tol={tol} max_iter={max_iter}"
        t0 = time.perf_counter()
        ref = quiet(p.solve, x0, check_every=1, **kw)
        torch.cuda.synchronize()
        log(f"phase 11b [{card}]: {what}, check_every=1: status {ref.status} nit {ref.nit} "
            f"nit_internal {ref.nit_internal} wall {time.perf_counter() - t0:.3f} s")
        for ce in (8, 64):
            before = graph_counts()
            t0 = time.perf_counter()
            got = quiet(p.solve, x0, check_every=ce, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            graphs = graphs_since(before)
            capture_ms = last_capture_ms(before)
            same_state(got.state, ref.state, f"phase 11b: {what}, check_every={ce} against 1")
            if graphs != {"captures": 1, "replays": -(-got.nit // ce) - 1}:
                raise AssertionError(f"phase 11b: {what}, check_every={ce}: graphs {graphs}")

            def eager(ce=ce, kw=kw):
                with eager_chunks():
                    quiet(p.solve, x0, check_every=ce, **kw)

            walls = in_turns({"graph": lambda ce=ce, kw=kw: quiet(p.solve, x0, check_every=ce, **kw),
                              "eager": eager}, ("graph", "eager"))
            steps = steps_run(got.nit, ce)
            log(
                f"phase 11b [{card}]: {what}, check_every={ce}: bitwise check_every=1 in every "
                f"State field; first solve {wall:.3f} s (the capture {capture_ms:.1f} ms "
                f"of host time; chunk graphs {graphs}); ms a step over the {steps} steps run, in "
                f"turns: cached graph {per_step(walls['graph'], steps)}, eager chunks "
                f"{per_step(walls['eager'], steps)}"
            )


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
JOS1_LANES, FDS_LANES, FDS_CHUNK, CHUNK_ITERS, FDS_SUBSET = 10_000, 1024, 256, 10, 64
COUNT_WIDTHS, COUNT_ITERS, COUNT_RTOL = (16, 1024), 1, 0.01


def phase12_tasks(dev) -> list:
    """Phase 12's pool work: every (problem, variant) batch over the window
    on both devices, to the end for m<=2, and (d)'s wide FDS batch."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    tasks = [("fds_wide", str(dev))]
    for i, (p, _, _) in enumerate(initialize_problems(large=False)):
        for v in _effective_variants(p, None):
            for d in (str(dev), "cpu"):
                tasks.append((i, v, None, d, True))
                if p.n_objectives <= 2:
                    tasks.append((i, v, None, d, False))
    return tasks


def fds_wide(device: str) -> dict:
    """(d), in a worker: FDS n=10 from FDS_LANES starts (benchmark()'s box,
    seed 42), float64, the harness's accelerated variant, to the end at
    ``check_every=8`` (every lane one Newton iteration of its own trial a
    step, on replayed graphs; a first solve and a repeat on the cached
    graph), and the round-based ``check_every=1`` batch of its first
    FDS_SUBSET starts, which its lanes must equal bit for bit."""
    from zfista_tpu_torch.models import FDS

    p = FDS(n_features=10)
    x0s = torch.tensor(np.random.default_rng(42).uniform(-2.0, 2.0, size=(FDS_LANES, 10)), device=device)
    kw = dict(nesterov=True, tol_internal=HARNESS_TOL_INTERNAL, max_iter=HARNESS_MAX_ITER)
    walls, graphs = [], []
    for _ in range(2):
        before = graph_counts()
        t0 = time.perf_counter()
        res = p.solve_batch(x0s, check_every=8, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        graphs.append(graphs_since(before))
    t0 = time.perf_counter()
    sub = p.solve_batch(x0s[:FDS_SUBSET], **kw)
    sub_wall = time.perf_counter() - t0
    same = all(
        np.array_equal(a[:FDS_SUBSET], c, equal_nan=True) and a.dtype == c.dtype
        for a, c in zip(res.state, sub.state)
    )
    return dict(status=res.status, nit=res.nit, nit_internal=res.nit_internal, x=res.x,
                wall=walls, graphs=graphs, sub_wall=sub_wall, same=same)


#: Phase 12a: the share of a batch's lanes that may fall outside phase 10's
#: classes card against CPU, each with the same status.  A hundred starts
#: find the lanes whose path turns on a rounding-floor decision (a marginal
#: line-search accept, a bisection end point, a Newton stall test); the
#: single solves of phase 10 met none.  On the CPU alone a start changed by
#: one part in 1e15 moves such a lane's inner count (JOS1 n=5 with L1,
#: accelerated, start 53: 24 to 98; FDS start 54: 379 to 258 Newton steps)
#: and, after a flip, the point where it stops within tol.
BATCH_OUTLIERS = 0.1

#: Phases 12g, ``large_recheck`` and ``large_report``: the (cell, variant)
#: pairs whose lanes end at the rounding floor, each with the share of its
#: lanes that may fall outside 12a's classes at the end in place of
#: ``BATCH_OUTLIERS``.  ZDT1 n = 100 under Normal (ISTA): card against CPU
#: 32 of 100 lanes outside (``large_recheck``), statuses equal; on the CPU
#: alone the same starts moved by one ulp put 26 of 100 outside, fun up
#: to 1.5e-4 relative, nit at most one apart (``ulp_spread``), so any
#: difference of rounding shows there, whichever device makes it.  The
#: window stays exact.
FLOOR_OUTLIERS = {("ZDT1_n_100_bounds_1e-06_inf", "Normal"): 0.32}


def large_extract(out: str, dest: str) -> None:
    """The per-lane fields of a ``runtests_torch.py --large`` run's cells
    (its ``<out>/cache/*.pkl``) into one ``.npz`` at ``dest``: for each cell
    and variant ``nit``, ``nit_internal``, ``status``, ``x``, ``fun`` and the
    variant's wall (the lanes' amortized times summed), keyed
    ``<cell>|<variant>|<field>``.  The history rows stay behind."""
    import pickle

    from zfista_tpu_torch.bench.harness import initialize_problems

    arrays = {}
    for p, _, _ in initialize_problems(large=True):
        path = Path(out) / "cache" / f"{p.name}.pkl"
        if not path.exists():
            continue
        with open(path, "rb") as fh:
            results = pickle.load(fh)["results"]
        for v, lanes in results.items():
            key = f"{p.name}|{v}|"
            for field in ("nit", "nit_internal", "status"):
                arrays[key + field] = np.array([r[field] for r in lanes])
            arrays[key + "x"] = np.stack([np.asarray(r["x"]) for r in lanes])
            arrays[key + "fun"] = np.stack([np.atleast_1d(r["fun"]) for r in lanes])
            arrays[key + "wall"] = np.array(sum(float(r["time"]) for r in lanes))
    np.savez_compressed(dest, **arrays)
    log(f"large_extract: {len(arrays) // 6} (cell, variant) pairs of {out} into {dest}")


#: ``large_report``: starts of a CPU batch task (the CPU's share of the
#: pool, split so that no task runs for many minutes).
REPORT_PART = 10

#: Phase 12g: starts of each large-only cell, the first rows of
#: benchmark()'s draw (cut from its 100 to keep the phase near two minutes;
#: the CPU's JOS1 ISTA batches at n >= 500 set its length).
LARGE_STARTS = 8


def large_cells() -> list[int]:
    """Indices into ``initialize_problems(large=True)`` of the cells that
    only the ``--large`` sweep runs (25: JOS1 at n = 10 ... 1000 and FDS at
    n = 5 ... 100, plain, L1 and bounded; ZDT1 at n = 100)."""
    from zfista_tpu_torch.bench.harness import initialize_problems

    small = {p.name for p, _, _ in initialize_problems(large=False)}
    return [i for i, (p, _, _) in enumerate(initialize_problems(large=True)) if p.name not in small]


def phase12g_tasks(dev) -> list:
    """12g's pool work: each large-only cell and variant over the window on
    both devices; the m <= 2 ones to the end on both; the m >= 3
    accelerated ones to the end on the card."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    problems = initialize_problems(large=True)
    tasks = []
    for i in large_cells():
        p = problems[i][0]
        for v in _effective_variants(p, None):
            for d in (str(dev), "cpu"):
                tasks.append(("large", i, v, d, True))
                if p.n_objectives <= 2:
                    tasks.append(("large", i, v, d, False))
            if p.n_objectives >= 3 and v != "Normal":
                tasks.append(("large", i, v, str(dev), False))
    return tasks + [("large", large_few_cell(), "Normal", str(dev), False, LARGE_STARTS, LARGE_FEW)]


#: Phase 12g: lanes of ZDT1 n = 100 (Normal, to the end) that also run on
#: the card as a batch of their own, to be bitwise the same lanes of the
#: ``LARGE_STARTS``-lane batch: each at another place among fewer lanes.
LARGE_FEW = (3, 8)


def large_few_cell() -> int:
    """The index of ZDT1 n = 100 in ``initialize_problems(large=True)``."""
    from zfista_tpu_torch.bench.harness import initialize_problems

    return next(i for i, (p, _, _) in enumerate(initialize_problems(large=True))
                if p.name.startswith("ZDT1_n_100_"))


def large_solve(i: int, variant: str, device: str, window: bool, starts: int = LARGE_STARTS,
                part: tuple | None = None, moved: bool = False) -> dict:
    """One 12g task, in a worker: large-only cell ``i``'s first ``starts``
    starts of ``benchmark()``'s draw (rows ``part[0]:part[1]`` of them when
    given: a lane's result does not depend on the lanes beside it; with
    ``moved``, every coordinate but the first moved up by one ulp) under
    ``variant``, float64, with history: over the window (tol 0, as 12a) or
    to the end as the harness's ``benchmark()`` batches them."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    problem, low, high = initialize_problems(large=True)[i]
    opts = _effective_variants(problem, None)[variant]
    x0s = np.random.default_rng(42).uniform(low, high, size=(starts, problem.n_features))
    if part is not None:
        x0s = x0s[part[0]:part[1]]
    if moved:  # every coordinate but the first one ulp up
        x0s[:, 1:] = np.nextafter(x0s[:, 1:], np.inf)
    t0 = time.perf_counter()
    kw = dict(max_iter=WINDOW, tol=0) if window else dict(max_iter=HARNESS_MAX_ITER)
    res = problem.solve_batch(torch.tensor(x0s, device=device), history=True,
                              tol_internal=HARNESS_TOL_INTERNAL, **kw, **opts)
    out = dict(nit=res.nit, nit_internal=res.nit_internal, status=res.status, x=res.x,
               fun=np.reshape(res.fun, (len(x0s), -1)))
    if not window and part is None:  # the per-lane results calculate_metrics reads
        out["results"] = res.to_list()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    return {k: v if k in ("wall", "results") else np.asarray(v) for k, v in out.items()}


def phase12g(card: str, dev, results: dict) -> None:
    """The 25 cells that only ``runtests_torch.py --large`` runs, at their
    own sizes, through ``benchmark()``'s batch as 12a runs the others,
    ``LARGE_STARTS`` starts each, float64, card against CPU: over the
    window lane by lane in phase 10's classes for every cell and variant
    (at most ``BATCH_OUTLIERS`` of the lanes outside, m >= 3 inner counts
    per batch within 25%); the m <= 2 ones to the end on both, in 12a's
    classes (at most ``BATCH_OUTLIERS`` of the lanes outside, every lane
    with the same status) and each cell's metrics in 13a's classes (Error
    rate equal, Hypervolume within ``HV_RTOL``, Avg iterations within
    ``NIT_RTOL``); ZDT1 n = 100's lanes ``LARGE_FEW`` as a batch of their
    own on the card bitwise the same lanes among all; the m >= 3
    accelerated variants to the end on the card, where every lane
    converges (BENCHMARKS.md's record of the sweep: only ISTA ends at the
    iteration cap there)."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems
    from zfista_tpu_torch.metrics import calculate_metrics

    problems = initialize_problems(large=True)
    gates = {"Error rate": 0.0, "Hypervolume": HV_RTOL, "Avg iterations": NIT_RTOL}
    failures, card_s = [], 0.0
    for i in large_cells():
        p = problems[i][0]
        m = p.n_objectives
        variants = list(_effective_variants(p, None))
        for v in variants:
            wc, wp = results[("large", i, v, str(dev), True)], results[("large", i, v, "cpu", True)]
            fc = results.get(("large", i, v, str(dev), False))
            fp = results.get(("large", i, v, "cpu", False))
            lanes = compare_lanes(dict(wc, nit_internal=wp["nit_internal"]) if m >= 3 else wc,
                                  wp, None, None, m)
            outside = [j for j, lane in enumerate(lanes) if not lane[0]]
            inner_c, inner_p = int(np.sum(wc["nit_internal"])), int(np.sum(wp["nit_internal"]))
            card_s += wc["wall"] + (fc["wall"] if fc else 0.0)
            msg = (
                f"phase 12g [{card}]: {p.name} / {v} (m={m}), {LARGE_STARTS} starts: window card "
                f"{wc['wall']:.3f} s, CPU {wp['wall']:.3f} s, inner count {inner_c} card, "
                f"{inner_p} CPU; lanes outside phase 10's classes {len(outside)}"
            )
            if fc is not None:
                msg += (f"; to the end on the card {fc['wall']:.3f} s (statuses "
                        f"{np.bincount(fc['status'], minlength=3).tolist()}, nit mean "
                        f"{float(np.mean(fc['nit'])):.1f} max {int(np.max(fc['nit']))})")
            end_outside = []
            if fp is not None:
                end = compare_lanes(fc, fp, fc, fp, m)
                end_outside = [j for j, lane in enumerate(end) if not lane[0]]
                msg += (f", on the CPU {fp['wall']:.3f} s, statuses equal: "
                        f"{np.array_equal(fc['status'], fp['status'])}; at the end lanes outside "
                        f"12a's classes {end_outside}, largest x deviation "
                        f"{max(lane[1] for lane in end)!r}, fun deviation "
                        f"{max(lane[2] for lane in end)!r}")
            log(msg)
            if len(end_outside) > FLOOR_OUTLIERS.get((p.name, v), BATCH_OUTLIERS) * LARGE_STARTS:
                failures.append(f"{p.name} / {v}: at the end lanes outside {end_outside}")
            for j in outside:
                log(f"phase 12g:   lane {j}: window nit {wc['nit'][j]}/{wp['nit'][j]} inner "
                    f"{wc['nit_internal'][j]}/{wp['nit_internal'][j]} x deviation {lanes[j][1]!r}")
            if len(outside) > BATCH_OUTLIERS * LARGE_STARTS or abs(inner_c - inner_p) > 0.25 * inner_p:
                failures.append(f"{p.name} / {v}: window lanes outside {outside}, inner {inner_c}/{inner_p}")
            if fp is not None and not np.array_equal(fc["status"], fp["status"]):
                failures.append(f"{p.name} / {v}: statuses {fc['status'].tolist()} card, "
                                f"{fp['status'].tolist()} CPU")
            if m >= 3 and fc is not None and not np.all(fc["status"] == 1):
                failures.append(f"{p.name} / {v}: statuses {fc['status'].tolist()} on the card")
        if m <= 2:
            got = {d: calculate_metrics(*((v, results[("large", i, v, d, False)]["results"])
                                          for v in variants))[0] for d in (str(dev), "cpu")}
            devs = {(metric, v): _rel(float(got[str(dev)][metric][v]), float(got["cpu"][metric][v]))
                    for metric in gates for v in variants}
            log(f"phase 12g [{card}]: {p.name}: metrics to the end, largest deviation card vs CPU: "
                + ", ".join(f"{metric} {max(d for (k, _), d in devs.items() if k == metric):.3g}"
                            for metric in gates))
            failures += [f"{p.name} / {v}: {metric} deviates by {d!r}"
                         for (metric, v), d in devs.items() if not d <= gates[metric]]
    # A lane's bits do not depend on the lanes beside it on the card either.
    i, (lo, hi) = large_few_cell(), LARGE_FEW
    few = results[("large", i, "Normal", str(dev), False, LARGE_STARTS, LARGE_FEW)]
    whole = results[("large", i, "Normal", str(dev), False)]
    differ = [k for k in ("nit", "nit_internal", "status", "x", "fun")
              if not np.array_equal(few[k], whole[k][lo:hi])]
    log(f"phase 12g [{card}]: {problems[i][0].name} / Normal: lanes {lo}-{hi - 1} as a batch of "
        f"their own on the card against the same lanes among {LARGE_STARTS}: fields not bitwise "
        f"the same {differ}")
    if differ:
        failures.append(f"{problems[i][0].name} / Normal: lanes {lo}-{hi - 1} alone differ in {differ}")
    log(f"phase 12g [{card}]: card seconds of its tasks, summed over the pool's workers: {card_s:.1f}")
    for f in failures:
        log(f"phase 12g: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 12g: {len(failures)} large-only batches do not hold")


def large_report(lanes_npz: str) -> None:
    """The full ``--large`` sweep on the card (``large_extract``'s file of
    a ``runtests_torch.py --large`` run) against the CPU, lane by lane, and
    its table.  For the m <= 2 large-only cells the same batches to the
    end on this machine's CPU (float64, ``BATCH_STARTS`` starts), held in
    12a's classes at the end (``compare_lanes``: equal nit and inner
    count, x within 1e-8, equal status, fun within 1e-6 relative; at most
    ``BATCH_OUTLIERS`` of the lanes outside); for the m >= 3 ones the
    window on the card and on the CPU (12a's m >= 3 classes).  Prints one
    table row per cell of the sweep (each variant's converged starts, mean
    and max nit; the cell's card wall) and the structure of BENCHMARKS.md's
    record of the sweep: Accelerated converged everywhere but ZDT1, ZDT1's
    Accelerated failing on every start, the projected variant converged
    on every bounded cell, iteration-cap exits only in Normal on FDS
    cells, and the median Normal/Accelerated mean-nit ratio."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    card = np.load(lanes_npz)
    dev = torch.device("cuda", 0)
    problems = initialize_problems(large=True)
    # The CPU's batches in parts of REPORT_PART starts, one task each: a
    # lane's result does not depend on the lanes beside it.
    parts = [(lo, min(lo + REPORT_PART, BATCH_STARTS)) for lo in range(0, BATCH_STARTS, REPORT_PART)]
    tasks = []
    for i in large_cells():
        p = problems[i][0]
        for v in _effective_variants(p, None):
            tasks += [("large", i, v, "cpu", p.n_objectives >= 3, BATCH_STARTS, part) for part in parts]
            if p.n_objectives >= 3:
                tasks.append(("large", i, v, str(dev), True, BATCH_STARTS, None))
    pooled = run_pool("the --large report", dev, tasks)

    def joined(i, v, device, window):
        if device != "cpu":
            return pooled[("large", i, v, device, window, BATCH_STARTS, None)]
        got = [pooled[("large", i, v, "cpu", window, BATCH_STARTS, part)] for part in parts]
        return {k: np.concatenate([g[k] for g in got]) for k in ("nit", "nit_internal", "status", "x", "fun")}

    failures = []

    def lanes_of(name, v):
        return {k: card[f"{name}|{v}|{k}"] for k in ("nit", "nit_internal", "status", "x", "fun")}

    for i in large_cells():
        p = problems[i][0]
        m = p.n_objectives
        for v in _effective_variants(p, None):
            if m <= 2:
                c, cp = lanes_of(p.name, v), joined(i, v, "cpu", False)
                lanes = compare_lanes(c, cp, c, cp, m)
                c_or_w = c
                same_status = np.array_equal(c["status"], cp["status"])
                what = "to the end"
            else:
                wc, cp = joined(i, v, str(dev), True), joined(i, v, "cpu", True)
                lanes = compare_lanes(dict(wc, nit_internal=cp["nit_internal"]), cp, None, None, m)
                c_or_w = wc
                same_status = True
                what = f"over the window ({WINDOW} iterations)"
            outside = [j for j, lane in enumerate(lanes) if not lane[0]]
            log(f"large report: {p.name} / {v}: card against CPU {what}: lanes outside 12a's "
                f"classes {outside}, largest x deviation {max(lane[1] for lane in lanes)!r}, "
                f"statuses equal {same_status}")
            for j in outside:
                log(f"large report:   lane {j}: nit {c_or_w['nit'][j]}/{cp['nit'][j]} inner "
                    f"{c_or_w['nit_internal'][j]}/{cp['nit_internal'][j]} status "
                    f"{c_or_w['status'][j]}/{cp['status'][j]} x deviation {lanes[j][1]!r} fun "
                    f"deviation {lanes[j][2]!r}")
            if len(outside) > FLOOR_OUTLIERS.get((p.name, v), BATCH_OUTLIERS) * BATCH_STARTS or not same_status:
                failures.append(f"{p.name} / {v}")
    ratios, caps = [], []
    log("large report: | cell | " + " | ".join(
        f"{v}: conv, mean nit, max nit" for v in ("Normal", "Accelerated", "Accelerated (deprecated)",
                                                   "Accelerated (projected)")) + " | card s |")
    for p, _, _ in problems:
        row, wall = [], 0.0
        for v in ("Normal", "Accelerated", "Accelerated (deprecated)", "Accelerated (projected)"):
            if f"{p.name}|{v}|status" not in card:
                row.append("-")
                continue
            st, nit = card[f"{p.name}|{v}|status"], card[f"{p.name}|{v}|nit"]
            conv = int(np.sum(st == 1))
            wall += float(card[f"{p.name}|{v}|wall"])
            row.append(f"{conv}, {float(np.mean(nit[st == 1])) if conv else float('nan'):.1f}, "
                       f"{int(np.max(nit))}")
            if np.any(st == 0):
                caps.append(f"{p.name} / {v}: {int(np.sum(st == 0))}")
            zdt1 = p.name.startswith("ZDT1")
            bad = {"Accelerated": conv != (0 if zdt1 else len(st)),
                   "Accelerated (projected)": conv != len(st)}.get(v, False)
            if bad:
                failures.append(f"{p.name} / {v}: {conv} of {len(st)} converged")
        log(f"large report: | {p.name} | " + " | ".join(row) + f" | {wall:.1f} |")
        n_key, a_key = f"{p.name}|Normal|", f"{p.name}|Accelerated|"
        if f"{a_key}status" in card and np.all(card[f"{a_key}status"] == 1):
            ok_n = card[f"{n_key}status"] == 1
            if ok_n.any():
                ratios.append(float(np.mean(card[f"{n_key}nit"][ok_n]) / np.mean(card[f"{a_key}nit"])))
    walls = {v: sum(float(card[k]) for k in card.files if k.endswith(f"|{v}|wall"))
             for v in ("Normal", "Accelerated", "Accelerated (deprecated)", "Accelerated (projected)")}
    log(f"large report: iteration-cap exits (lanes): {caps}")
    if any(not c.startswith("FDS") or "/ Normal:" not in c for c in caps):
        failures.append(f"cap exits outside Normal on FDS: {caps}")
    log(f"large report: median Normal/Accelerated mean-nit ratio over {len(ratios)} cells "
        f"{statistics.median(ratios)!r} (range {min(ratios)!r} to {max(ratios)!r}); card "
        f"seconds by variant {walls}, in all {sum(walls.values()):.1f}")
    for f in failures:
        log(f"large report: MISMATCH {f}")
    if failures:
        raise AssertionError(f"large report: {len(failures)} cells do not hold")


def large_recheck(dev) -> None:
    """ZDT1 n = 100, every variant, all ``BATCH_STARTS`` of
    ``benchmark()``'s starts to the end through its batch, on the card and
    on this machine's CPU (tasks of ``run_pool``), float64, lane by lane
    in 12a's classes as ``large_report`` holds the --large sweep (at most
    ``BATCH_OUTLIERS`` of the lanes outside, every lane with the same
    status), and the card's row of its table (the last column: the card
    batches' walls in the pool).  Standalone:
    ``python3 -c "import torch, chip_smoke as c; c.large_recheck(torch.device('cuda', 0))"``."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    i = large_few_cell()
    p = initialize_problems(large=True)[i][0]
    variants = list(_effective_variants(p, None))
    tasks = [("large", i, v, d, False, BATCH_STARTS, None) for v in variants for d in (str(dev), "cpu")]
    got = run_pool(f"{p.name}, {BATCH_STARTS} starts", dev, tasks)
    failures, row, wall = [], [], 0.0
    for v in variants:
        c, cp = (got[("large", i, v, d, False, BATCH_STARTS, None)] for d in (str(dev), "cpu"))
        lanes = compare_lanes(c, cp, c, cp, 2)
        outside = [j for j, lane in enumerate(lanes) if not lane[0]]
        same = np.array_equal(c["status"], cp["status"])
        conv = c["status"] == 1
        wall += c["wall"]
        row.append(f"{int(conv.sum())} · "
                   + (f"{float(np.mean(c['nit'][conv])):.1f}" if conv.any() else "–")
                   + f" · {int(np.max(c['nit']))}")
        log(f"large recheck: {p.name} / {v}: card against CPU to the end: lanes outside 12a's "
            f"classes {outside}, largest x deviation {max(lane[1] for lane in lanes)!r}, fun "
            f"deviation {max(lane[2] for lane in lanes)!r}, statuses equal {same}; card "
            f"{c['wall']:.3f} s, CPU {cp['wall']:.3f} s")
        if len(outside) > FLOOR_OUTLIERS.get((p.name, v), BATCH_OUTLIERS) * BATCH_STARTS or not same:
            failures.append(f"{p.name} / {v}: lanes outside {outside}, statuses equal {same}")
    log("large recheck: | ZDT1 100 | " + " | ".join(row) + f" | {wall:.1f} |")
    for f in failures:
        log(f"large recheck: MISMATCH {f}")
    if failures:
        raise AssertionError(f"large recheck: {len(failures)} variants do not hold")


def ulp_spread(starts: int = BATCH_STARTS) -> list[int]:
    """On this machine's CPU, float64, no card: ZDT1 n = 100 under Normal
    from ``benchmark()``'s first ``starts`` starts to the end, against the
    same batch from those starts with every coordinate but the first moved
    up by one ulp, lane by lane in 12a's classes.  Prints and returns the
    lanes outside: the share of lanes whose end a difference of rounding
    moves past those classes (``FLOOR_OUTLIERS``).  Standalone:
    ``python3 -c "import chip_smoke as c; c.ulp_spread()"`` (~30 s)."""
    i = large_few_cell()
    a = large_solve(i, "Normal", "cpu", False, starts)
    b = large_solve(i, "Normal", "cpu", False, starts, moved=True)
    lanes = compare_lanes(a, b, a, b, 2)
    outside = [j for j, lane in enumerate(lanes) if not lane[0]]
    log(f"ulp spread: ZDT1 n = 100 / Normal on the CPU, {starts} starts against the same moved "
        f"by one ulp: lanes outside 12a's classes at the end {len(outside)} {outside}, largest x "
        f"deviation {max(lane[1] for lane in lanes)!r}, fun deviation "
        f"{max(lane[2] for lane in lanes)!r}, statuses equal "
        f"{np.array_equal(a['status'], b['status'])}, nit apart at most "
        f"{int(np.max(np.abs(a['nit'] - b['nit'])))}")
    return outside


def phase12a(card: str, dev, results: dict, singles: dict) -> None:
    """The harness's 15 problems under every variant as ``benchmark()``
    runs them: one batch of ``BATCH_STARTS`` starts, ``history=True``,
    float64, card against CPU lane by lane in phase 10's classes
    (``compare_lanes``), over the window for every problem, to the end for
    m<=2 (an m>=3 batch of 100 starts runs for minutes on the CPU and on
    the card's per-step history; (d) runs one to the end).  The m>=3 card
    windows run on the graphed history, bitwise the per-step history
    (``window_turns``).  Every lane must end with the same status,
    at most ``BATCH_OUTLIERS`` of a batch's lanes may fall outside the
    classes (each printed), and for m>=3 the inner counts are held per
    batch (its total within 25%): per lane they are not reproducible.
    Walls per batch inside the pool, beside phase 10's single solves."""
    from zfista_tpu_torch.bench.harness import _effective_variants, initialize_problems

    failures = []
    problems = initialize_problems(large=False)
    for i, (p, _, _) in enumerate(problems):
        m = p.n_objectives
        for v in _effective_variants(p, None):
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
            one = singles.get((p.name, v))
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
                    f"{float(np.mean(fc['nit'])):.1f} max {int(np.max(fc['nit']))})"
                )
                if one is not None:  # phase 10 ran
                    msg += (
                        f"; one start alone (phase 10): card {one['cuda'][0]:.3f} s, CPU "
                        f"{one['cpu'][0]:.3f} s, {BATCH_STARTS} of them one by one on one CPU "
                        f"core ~{BATCH_STARTS * one['cpu'][0]:.1f} s"
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
            if full and not history_turns_ok(card, p.name, v, fc["turns"]):
                failures.append(f"{p.name} / {v}: the graphed history differs from the eager one "
                                f"or ran no graph: {fc['turns']}")
            if not full and not history_turns_ok(card, p.name, f"{v} (window)", wc["turns"]):
                # m >= 3: the window on the graphed history (carried Newton
                # steps) against the per-step history.
                failures.append(f"{p.name} / {v}: the graphed window history differs from the "
                                f"eager one or ran no graph: {wc['turns']}")
    for f in failures:
        log(f"phase 12a: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 12a: {len(failures)} batches differ card against CPU")


def history_turns_ok(card: str, name: str, variant: str, t: dict) -> bool:
    """12a's line on one m <= 2 card batch's history runs
    (:func:`history_turns`), and whether they held: every graphed run
    bitwise the eager per-step history, one capture on the first solve."""
    rows = max(t["rows"], 1)
    log(
        f"phase 12a [{card}]: {name} / {variant}: history on replayed graphs of {t['steps']} "
        f"steps (chunk graphs {t['graphs']}"
        + (f"; to the end, a first solve, {t['end']:.3f} s" if "end" in t else "")
        + f"); over the first {WINDOW} iterations ({t['rows']} rows) bitwise the eager per-step "
        f"history (State, allfuns, allerrs, history_mask): {t['same']}; first-solve walls in "
        f"turns (graph, eager): graph {[round(w, 4) for w in t['graph']]} s, eager "
        f"{[round(w, 4) for w in t['eager']]} s; host reads per row: graphed "
        f"{t['reads']['graph'] / rows!r}, eager {t['reads']['eager'] / rows!r} "
        f"({t['reads']['graph']} and {t['reads']['eager']})"
    )
    return t["same"] and t["graphs"]["captures"] == 1


def sweep_setup(dev) -> tuple:
    """The 1k-lambda elastic-net sweep's callables, starts and options."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep

    A_np, b_np = make_problem(*SWEEP_SHAPE)
    A, b = torch.as_tensor(A_np, device=dev), torch.as_tensor(b_np, device=dev)
    lams = np.logspace(-4, 0, SWEEP_LAMBDAS).astype(np.float32)
    lr = 1.0 / Lasso(A, b, 1.0, l2_ratio=SWEEP_MU).lipschitz()
    fns = make_lasso_lambda_sweep(A, b, l2_ratio=SWEEP_MU)
    x0s = torch.zeros((SWEEP_LAMBDAS, SWEEP_SHAPE[1]), dtype=torch.float32, device=dev)
    kw = dict(batch_params=torch.as_tensor(lams, device=dev), lr=lr, decay_rate=1, nesterov=True)
    return (A, b, lams, lr), fns, x0s, kw


def sweep_walls(dev) -> dict:
    """Walls of the 1k-lambda sweep (seconds): at ``check_every=1``, and at
    8 a first sweep (the graph cache emptied) and a repeat.  It drives only
    the public entry points, so a copy of this script in an older tree's
    root times that tree (run the two in turns)."""
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    _, fns, x0s, kw = sweep_setup(dev)
    minimize_proximal_gradient_batch(*fns, x0s, max_iter=2, **kw)  # first-use costs
    out = {}
    for key, every in (("one", 1), ("first", 8), ("repeat", 8)):
        if key == "first":
            solver._GRAPHS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = minimize_proximal_gradient_batch(*fns, x0s, max_iter=HARNESS_MAX_ITER,
                                               check_every=every, **kw)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    out["nit_max"] = int(np.max(res.nit))
    return out


#: Phase 12b: lanes of the sweep solved as a batch of their own, from each
#: of these lanes: the first, and across the edge between the first two
#: GEMM blocks of 512 lanes (ops/precision.py).
SWEEP_FEW = 16
SWEEP_FEW_FROM = (0, 505)


def phase12b(card: str, dev) -> None:
    """The 1k-lambda elastic-net sweep through ``make_lasso_lambda_sweep``."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    (A, b, lams, lr), fns, x0s, kw = sweep_setup(dev)
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
    # A lane's products with the shared operator run in GEMMs of a fixed
    # number of lanes (ops/precision.py), so lanes as a batch of their own
    # are the same bits as among all of them, whatever their place in a
    # block among all: the first rows of the first block, and the last rows
    # of the first block and the first of the second.
    for lo in SWEEP_FEW_FROM:
        hi = lo + SWEEP_FEW
        few_kw = dict(kw, batch_params=kw["batch_params"][lo:hi])
        few = minimize_proximal_gradient_batch(*fns, x0s[lo:hi], max_iter=HARNESS_MAX_ITER, **few_kw)
        same_state(few.state, type(res.state)(*(a[lo:hi] for a in res.state)),
                   f"phase 12b: lanes {lo}-{hi - 1} as a batch of {SWEEP_FEW} against the "
                   f"{SWEEP_LAMBDAS}-lane sweep")
        log(f"phase 12b [{card}]: lanes {lo}-{hi - 1} as a batch of their own, bitwise the same "
            f"lanes among all {SWEEP_LAMBDAS} in every State field")
    # The fixed-lr chunk as a replayed graph: check_every=8, a first sweep
    # (one eager chunk, the capture, the replays) and a repeat on the cached
    # graph, each bitwise the check_every=1 sweep in every field of every lane.
    graphed = {}
    for k in ("first", "repeat"):
        before = graph_counts()
        t0 = time.perf_counter()
        got = minimize_proximal_gradient_batch(*fns, x0s, max_iter=HARNESS_MAX_ITER, check_every=8, **kw)
        graphed[k] = (time.perf_counter() - t0, graphs_since(before), last_capture_ms(before))
        same_state(got.state, res.state, f"phase 12b: the {k} check_every=8 sweep against check_every=1")
    chunks = -(-int(np.max(res.nit)) // 8)
    if graphed["first"][1] != {"captures": 1, "replays": chunks - 1} or graphed["repeat"][1] != {
        "captures": 0, "replays": chunks}:
        raise AssertionError(f"phase 12b: chunk graphs {graphed}")
    log(
        f"phase 12b [{card}]: check_every=8 on replayed graphs, bitwise the check_every=1 sweep "
        f"in every field of every lane: a first sweep {graphed['first'][0]:.3f} s (the capture "
        f"{graphed['first'][2]:.1f} ms of host time; {graphed['first'][1]}), a repeat "
        f"{graphed['repeat'][0]:.3f} s ({graphed['repeat'][1]}), beside check_every=1's {wall:.3f} s"
    )
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
    lane on the Pareto set, the segment x = c 1, c in [0, 2]; at
    ``check_every=8`` (the line search as per-lane carried trials on
    replayed graphs) bitwise the ``check_every=1`` batch, timed beside."""
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
    graphed = {}
    for k in ("first", "repeat"):
        before = graph_counts()
        t0 = time.perf_counter()
        got = p.solve_batch(x0s, nesterov=True, tol=1e-5, check_every=8)
        graphed[k] = (time.perf_counter() - t0, graphs_since(before), last_capture_ms(before))
        same_state(got.state, res.state, f"phase 12c: the {k} check_every=8 batch against check_every=1")
    if graphed["first"][1]["captures"] != 1 or graphed["repeat"][1]["captures"] != 0:
        raise AssertionError(f"phase 12c: chunk graphs {graphed}")
    log(
        f"phase 12c [{card}]: check_every=8 (per-lane carried trials on replayed graphs), "
        f"bitwise the check_every=1 batch in every field of every lane: a first batch "
        f"{graphed['first'][0]:.3f} s (the capture {graphed['first'][2]:.1f} ms of host time; "
        f"{graphed['first'][1]}), a repeat {graphed['repeat'][0]:.3f} s "
        f"({graphed['repeat'][1]}), beside check_every=1's {wall:.3f} s"
    )


def phase12d(card: str, dev, wide: dict) -> None:
    """FDS n=10 from ``FDS_LANES`` starts (run to the end in the pool at
    ``check_every=8``, carried Newton steps on replayed graphs, its first
    ``FDS_SUBSET`` lanes bitwise their round-based batch), and
    ``lane_chunk=FDS_CHUNK`` bitwise equal to the unchunked batch over
    ``CHUNK_ITERS`` iterations (every State field)."""
    from zfista_tpu_torch.models import FDS

    counts = np.bincount(wide["status"], minlength=3).tolist()
    log(
        f"phase 12d [{card}]: FDS n=10 from {FDS_LANES} starts, f64, accelerated, check_every=8: "
        f"statuses {counts}, converged {float(np.mean(wide['status'] == 1))!r}, nit mean "
        f"{float(np.mean(wide['nit']))!r} max {int(np.max(wide['nit']))}, inner max "
        f"{int(np.max(wide['nit_internal']))}; wall first {wide['wall'][0]:.3f} s (chunk graphs "
        f"{wide['graphs'][0]}), repeat {wide['wall'][1]:.3f} s ({wide['graphs'][1]}); the "
        f"round-based batch of its first {FDS_SUBSET} starts {wide['sub_wall']:.3f} s, those "
        f"lanes bitwise equal (every State field): {wide['same']} (inside the pool of phases 10, "
        f"12 and 13)"
    )
    if counts[1] < 0.99 * FDS_LANES or not np.all(np.isfinite(wide["x"])):
        raise AssertionError("phase 12d: the FDS batch did not converge")
    if not wide["same"] or wide["graphs"][0]["captures"] != 1 or wide["graphs"][1]["captures"]:
        raise AssertionError(f"phase 12d: the carried FDS batch: {wide['graphs']}, bitwise {wide['same']}")
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
    the result's host copy cancel.  One uncounted solve of each problem
    goes first: a problem's first solve in the process makes a few host
    reads more (one-time set-up), which would land on the first width.
    Each run is counted at least twice, until one count repeats
    (:func:`most_events`): JOS1's 1,302 events an iteration leave the 1%
    bound 13 events and FDS's 4,420 (PR 15; ~15,800 before) 44, and the
    profiler has been 15-52 off in one count."""
    from zfista_tpu_torch.models import FDS, JOS1

    for name, p, low, high, times in (("JOS1 n=50", JOS1(n_features=50), -2.0, 4.0, 2),
                                      ("FDS n=10", FDS(n_features=10), -2.0, 2.0, 2)):
        base = torch.tensor(np.random.default_rng(42).uniform(low, high, (16, p.n_features)), device=dev)
        p.solve_batch(base, nesterov=True, tol=0, max_iter=COUNT_ITERS)  # the warm-up
        seen = {}
        for B in COUNT_WIDTHS:
            x0s = base.repeat(B // 16, 1)
            got = {}
            for its in (COUNT_ITERS, 2 * COUNT_ITERS):
                run = lambda: p.solve_batch(x0s, nesterov=True, tol=0, max_iter=its)
                got[its] = most_events(run, f"{name}, {B} lanes, {its} iterations", times, by_name=True)
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
        if abs(ra - rb) > COUNT_RTOL * max(ra, rb) or abs(ea - eb) > COUNT_RTOL * max(ea, eb):
            raise AssertionError(f"phase 12e: {name}'s counts depend on the width")
    phase12e_history(card, dev)
    phase12e_newton(card, dev)


#: Phase 12e: the most times one run is counted by the profiler.
MOST_EVENTS_COUNTS = 5


def most_events(run, what: str, times: int, by_name: bool = False) -> tuple:
    """``run()``'s host reads and device events, ``(reads, events, busy
    µs[, by name])`` as :func:`count_host_reads` and :func:`device_events`
    count them.  The run is deterministic and the sync check counts its
    reads exactly, but torch.profiler on the H100 miscounts device events
    now and then: counts of one FDS batch read 8,710, 8,709 and 8,708
    (PR 14), one count of a JOS1 batch lacked 15 (its initial State's
    fills and its first "any lane active" read), and in PR 15's calls a
    2-iteration JOS1 run read 2,643, 2,614 and 2,603 where 2,643 repeated,
    and a 1-iteration one 1,364 and 1,341 where 1,341 (2,643 less the
    1,302 an iteration both widths read) is the run's own.  So with
    ``times`` > 1 the run is counted again, up to ``MOST_EVENTS_COUNTS``
    times in all, until one event count has been read twice, and that
    count is kept (the largest when none repeats).  Counts that differ
    are logged; reads that differ fail."""
    counts = []

    def repeated():
        seen = [c[1] for c in counts]
        return next((c for c in counts if seen.count(c[1]) >= 2), None)

    while len(counts) < times or (
        times > 1 and repeated() is None and len(counts) < MOST_EVENTS_COUNTS
    ):
        events, reads = count_host_reads(lambda: device_events(run, by_name=by_name))
        counts.append((reads, *events))
    if len({c[0] for c in counts}) > 1:
        raise AssertionError(f"phase 12e: {what}: one run made {[c[0] for c in counts]} host reads")
    kept = (times > 1 and repeated()) or max(counts, key=lambda c: c[1])
    if len({c[1] for c in counts}) > 1:
        log(f"phase 12e: {what}: the profiler counted {[c[1] for c in counts]} device events "
            f"({counts[0][0]} host reads each); kept {kept[1]}")
    return kept


#: Phase 12e under history: JOS1's outer iterations counted, per iteration
#: from runs of HISTORY_COUNT_ITERS and twice that on their cached graphs.
HISTORY_COUNT_ITERS = 8


def phase12e_history(card: str, dev) -> None:
    """Host reads and device events per outer iteration of the JOS1 batch
    with ``history=True`` (its line search as per-lane carried trials, one
    trial an iteration at lr 1, on replayed history graphs) at each of
    ``COUNT_WIDTHS`` lanes: each run once uncounted first (the capture),
    then counted once on its cached graphs: over 8 and 16 iterations a
    miss of the size seen is a few tenths of a percent."""
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.models import JOS1

    p = JOS1(n_features=50)
    base = torch.tensor(np.random.default_rng(42).uniform(-2.0, 4.0, (16, 50)), device=dev)
    steps = solver.HISTORY_GRAPH_STEPS.get(2, 0)
    seen = {}
    for B in COUNT_WIDTHS:
        x0s = base.repeat(B // 16, 1)
        got = {}
        for its in (HISTORY_COUNT_ITERS, 2 * HISTORY_COUNT_ITERS):
            run = lambda: p.solve_batch(x0s, nesterov=True, tol=0, max_iter=its, history=True)
            run()
            before = graph_counts()
            got[its] = (*most_events(run, f"JOS1 with history, {B} lanes, {its} iterations", 1),
                        graphs_since(before))
        (r1, e1, b1, g1), (r2, e2, b2, g2) = got[HISTORY_COUNT_ITERS], got[2 * HISTORY_COUNT_ITERS]
        seen[B] = (r2 - r1, e2 - e1)
        log(
            f"phase 12e [{card}]: JOS1 n=50 with history=True, {B} lanes, history graphs of "
            f"{steps} steps: host reads {(r2 - r1) / HISTORY_COUNT_ITERS!r} and device events "
            f"{(e2 - e1) / HISTORY_COUNT_ITERS!r} per outer iteration, device busy "
            f"{(b2 - b1) / HISTORY_COUNT_ITERS:.1f} us per iteration (chunk graphs {g1}, {g2})"
        )
        if g1["captures"] or g2["captures"] or not g2["replays"]:
            raise AssertionError(f"phase 12e: the history runs did not replay cached graphs: {g1}, {g2}")
    (ra, ea), (rb, eb) = (seen[B] for B in COUNT_WIDTHS)
    if abs(ra - rb) > COUNT_RTOL * max(ra, rb) or abs(ea - eb) > COUNT_RTOL * max(ea, eb):
        raise AssertionError("phase 12e: JOS1's history counts depend on the width")


#: Phase 12e's carried FDS batch: outer iterations counted (past one chunk
#: of 8 steps, so that the chunks replay graphs), per iteration from runs of
#: NEWTON_COUNT_ITERS and twice that on their cached graphs.
NEWTON_COUNT_ITERS = 9


def phase12e_newton(card: str, dev) -> None:
    """Host reads and device events per outer iteration of the FDS batch at
    ``check_every=8`` (every lane one Newton iteration of its own trial a
    step, on replayed graphs) at each of ``COUNT_WIDTHS`` lanes, the 16
    starts tiled: each run once uncounted first (its eager chunk and the
    capture), then counted once on its cached graph, beside the eager
    ``check_every=1`` counts above."""
    from zfista_tpu_torch.models import FDS

    p = FDS(n_features=10)
    base = torch.tensor(np.random.default_rng(42).uniform(-2.0, 2.0, (16, 10)), device=dev)
    seen = {}
    for B in COUNT_WIDTHS:
        x0s = base.repeat(B // 16, 1)
        got = {}
        for its in (NEWTON_COUNT_ITERS, 2 * NEWTON_COUNT_ITERS):
            run = lambda: p.solve_batch(x0s, nesterov=True, tol=0, max_iter=its, check_every=8)
            run()
            before = graph_counts()
            got[its] = (*most_events(run, f"FDS at check_every=8, {B} lanes, {its} iterations", 1),
                        graphs_since(before))
        (r1, e1, b1, g1), (r2, e2, b2, g2) = got[NEWTON_COUNT_ITERS], got[2 * NEWTON_COUNT_ITERS]
        seen[B] = (r2 - r1, e2 - e1)
        per = NEWTON_COUNT_ITERS
        log(
            f"phase 12e [{card}]: FDS n=10 at check_every=8 (carried Newton steps), {B} lanes: "
            f"host reads {(r2 - r1) / per!r} and device events {(e2 - e1) / per!r} per outer "
            f"iteration, device busy {(b2 - b1) / per:.1f} us per iteration (chunk graphs {g1}, "
            f"{g2}; {g2['replays'] - g1['replays']} replays of 8 steps for {per} iterations)"
        )
        if g1["captures"] or g2["captures"] or not g1["replays"]:
            raise AssertionError(f"phase 12e: the carried FDS runs did not replay cached graphs: {g1}, {g2}")
    (ra, ea), (rb, eb) = (seen[B] for B in COUNT_WIDTHS)
    if abs(ra - rb) > COUNT_RTOL * max(ra, rb) or abs(ea - eb) > COUNT_RTOL * max(ea, eb):
        raise AssertionError("phase 12e: the carried FDS counts depend on the width")


def return_all_same(got, ref) -> bool:
    """Two ``return_all`` solves equal bit for bit: every State field and
    ``allvecs``, ``allfuns`` and ``allerrs``."""
    pairs = list(zip(got.state, ref.state)) + [
        (np.asarray(getattr(got, k)), np.asarray(getattr(ref, k)))
        for k in ("allvecs", "allfuns", "allerrs")
    ]
    return all(
        a.dtype == c.dtype and np.array_equal(a, c, equal_nan=a.dtype.kind == "f")
        for a, c in pairs
    )


def phase12f(card: str, dev, lz: dict) -> None:
    """The m = 1 history drivers at full width: the LASSO of phases 3-5
    and 9 by ``solve_fixed_step(return_all=True)`` (the fused step tail
    ``lasso_step_tail`` inside the history graph, beside its record rows)
    and by the backtracking ``solve(nesterov=True, return_all=True)`` (the
    carried search), each to its default tol, and 12b's 1k-lambda sweep
    with ``history=True``.  Each is a first solve on replayed history
    graphs of ``HISTORY_GRAPH_STEPS[1]`` steps (the graph cache emptied:
    one capture, replays counted), bitwise the eager per-step driver
    (``eager_chunks``) in its State and histories; first-solve walls in
    turns (graph, eager, graph) and host reads per history row."""
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    prob = Lasso(lz["A"], lz["b"], LAM)
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    A_np, b_np = make_problem(*SWEEP_SHAPE)
    A, b = torch.as_tensor(A_np, device=dev), torch.as_tensor(b_np, device=dev)
    lams = torch.as_tensor(np.logspace(-4, 0, SWEEP_LAMBDAS).astype(np.float32), device=dev)
    fns = make_lasso_lambda_sweep(A, b, l2_ratio=SWEEP_MU)
    x0s = torch.zeros((SWEEP_LAMBDAS, SWEEP_SHAPE[1]), dtype=torch.float32, device=dev)
    kw = dict(batch_params=lams, lr=1.0 / Lasso(A, b, 1.0, l2_ratio=SWEEP_MU).lipschitz(),
              decay_rate=1, nesterov=True)
    prob.solve_fixed_step(x0, max_iter=2)  # 1/L cached, first-use costs
    minimize_proximal_gradient_batch(*fns, x0s, max_iter=2, history=True, **kw)
    runs = {
        "Lasso.solve_fixed_step(return_all=True)": (
            lambda: prob.solve_fixed_step(x0, return_all=True), return_all_same,
            lambda r: len(r.allfuns)),
        "Lasso.solve(nesterov=True, return_all=True)": (
            lambda: prob.solve(x0, nesterov=True, return_all=True), return_all_same,
            lambda r: len(r.allfuns)),
        f"the {SWEEP_LAMBDAS}-lambda sweep with history=True": (
            lambda: minimize_proximal_gradient_batch(
                *fns, x0s, max_iter=HARNESS_MAX_ITER, history=True, **kw),
            history_same, lambda r: int(np.asarray(r.allfuns).shape[1])),
    }
    steps = solver.HISTORY_GRAPH_STEPS.get(1, 0)
    for name, (run, equal, rows) in runs.items():
        def first(graphs: bool):
            """A first solve, timed: graphed from an empty cache, or eager."""
            solver._GRAPHS.clear()
            torch.cuda.synchronize()
            before = graph_counts()
            t0 = time.perf_counter()
            with contextlib.nullcontext() if graphs else eager_chunks():
                res = run()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, graphs_since(before)

        graphed, g_wall, g_graphs = first(True)
        (eager, e_wall, e_graphs), e_reads = count_host_reads(lambda: first(False))
        (graphed2, g2_wall, _), g_reads = count_host_reads(lambda: first(True))
        same = equal(graphed, eager) and equal(graphed2, eager)
        n = max(rows(eager), 1)
        log(
            f"phase 12f [{card}]: {name} ({n} history rows): on replayed history graphs of "
            f"{steps} steps ({g_graphs}), bitwise the eager per-step driver (State and "
            f"histories): {same}; first-solve walls in turns: graph {g_wall:.4f} s, eager "
            f"{e_wall:.4f} s, graph {g2_wall:.4f} s; host reads per row: graphed "
            f"{g_reads / n!r}, eager {e_reads / n!r}"
        )
        graphed_ok = (g_graphs["captures"] == 1 and g_graphs["replays"] >= 1 if steps
                      else g_graphs == {"captures": 0, "replays": 0})
        if not (same and graphed_ok and e_graphs == {"captures": 0, "replays": 0}):
            raise AssertionError(f"phase 12f: {name}: graphed against eager {same}, "
                                 f"chunk graphs {g_graphs} and {e_graphs}")


#: Phase 13: the experiment layer (zfista_tpu_torch.bench, .metrics, .native,
#: .utils).  (a) the metrics of phase 12a's to-the-end batches (m<=2 cells),
#: card against CPU: Error rate equal, Hypervolume within HV_RTOL relative,
#: Avg iterations within NIT_RTOL; (b) the harness CLI over the 15 cells,
#: twice on one --out (the second run all cache hits); (c) the papers'
#: momentum sweeps that wrote examples/data/{JOS1,SD}_ab.csv (AB_STARTS
#: starts, seed 42, float64), every pair's mean nit within AB_NIT_RTOL of
#: the CSV's; (d) gap_bench.run() at its defaults; (e) restart_bench without
#: its TRIDIA row; (f) checkpoint (CKPT_STOP of CKPT_END iterations) and a
#: trace of TRACE_STEPS steps; (g) the native metrics against their numpy
#: paths on ND_POINTS and HV_POINTS 3-objective points.
HV_RTOL, NIT_RTOL = 1e-3, 0.05
CLI_ARGS = ("--no-plots", "--n-samples", "8", "--max-iter", "2")
AB_STARTS, AB_NIT_RTOL = 1000, 0.02
AB_BOXES = {"JOS1": (-2.0, 4.0), "SD": (1.0, 2.0)}
RESTART_FRTOL = 1e-4
CKPT_STOP, CKPT_END, TRACE_STEPS = 100, 300, 20
ND_POINTS, HV_POINTS = 2000, 200


def phase13_tasks(dev) -> list:
    """Phase 13's pool work: (b)'s CLI runs and (c)'s two sweeps."""
    return [("sweep", name, str(dev)) for name in AB_BOXES] + [("cli", str(dev))]


def cli_runs(device: str) -> dict:
    """(b), in a worker: ``python -m zfista_tpu_torch.bench.harness`` over
    the 15 cells with ``CLI_ARGS``, twice on one ``--out``.  ``benchmark``
    is wrapped to count the cells each run solves."""
    from zfista_tpu_torch.bench import harness

    real, solved = harness.benchmark, []

    def counted(problem, *args, **kwargs):
        solved.append(problem.name)
        return real(problem, *args, **kwargs)

    harness.benchmark = counted
    out = {"walls": [], "solved": []}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--device", device, *CLI_ARGS, "--out", tmp]
            blobs = []
            for _ in range(2):
                solved.clear()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
                    harness.main(argv)
                out["walls"].append(time.perf_counter() - t0)
                out["solved"].append(list(solved))
                blobs.append({p.parent.name: p.read_bytes() for p in Path(tmp).glob("*/metrics.json")})
            out["cells"] = len(blobs[0])
            out["same_bytes"] = blobs[0] == blobs[1]
            csv, js = Path(tmp) / "metrics.csv", Path(tmp) / "metrics.json"
            out["artefact"] = csv.name if csv.exists() else js.name
            out["rows"] = (
                len(csv.read_text().splitlines()) - 1 if csv.exists() else len(json.loads(js.read_text()))
            )
    finally:
        harness.benchmark = real
    return out


def sweep_run(name: str, device: str) -> dict:
    """(c), in a worker: ``momentum_sweep`` as examples/momentum_experiment.py
    runs it (``AB_STARTS`` starts, seed 42, float64, measured times)."""
    from zfista_tpu_torch.bench.momentum_sweep import momentum_sweep
    from zfista_tpu_torch.models import JOS1, SD

    prob = JOS1(n_features=50) if name == "JOS1" else SD()
    low, high = AB_BOXES[name]
    t0 = time.perf_counter()
    rows, res = momentum_sweep(prob, low, high, n_starts=AB_STARTS, seed=42, device=device)
    return dict(
        rows=rows, wall=time.perf_counter() - t0, lanes=len(res.nit),
        nit_max=int(np.max(res.nit)), dtype=str(res.x.dtype),
    )


def _rel(a: float, b: float) -> float:
    """|a - b| relative to the larger; 0 for equal values (inf or NaN
    included), inf where only one is finite."""
    if a == b or (math.isnan(a) and math.isnan(b)):
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(a), abs(b))


def phase13a(card: str, dev, results: dict) -> None:
    """The harness's metrics on the card against the CPU: each m<=2 cell's
    to-the-end batches of phase 12a (one ``benchmark()`` per variant)
    through ``calculate_metrics``, then ``performance_profiles`` over the
    cells.  Gates: Error rate equal, Hypervolume within ``HV_RTOL``, Avg
    iterations within ``NIT_RTOL``; the other metrics are printed (Purity,
    Gamma and Delta count membership in the pooled front, which one lane at
    the rounding floor moves by 1/|front|)."""
    from zfista_tpu_torch.bench.harness import (
        _effective_variants,
        initialize_problems,
        performance_profiles,
    )
    from zfista_tpu_torch.metrics import calculate_metrics

    gates = {"Error rate": 0.0, "Hypervolume": HV_RTOL, "Avg iterations": NIT_RTOL}
    worst: dict[str, float] = {}
    ratios: dict[str, dict] = {str(dev): {}, "cpu": {}}
    failures = []
    for i, (p, _, _) in enumerate(initialize_problems(large=False)):
        if p.n_objectives > 2:
            continue
        variants = list(_effective_variants(p, None))
        got = {}
        for d in ratios:
            metrics, ratios[d][p.name] = calculate_metrics(
                *((v, results[(i, v, None, d, False)]["results"]) for v in variants)
            )
            got[d] = metrics
        cell = {}
        for metric, per in got[str(dev)].items():
            devs = {v: _rel(float(per[v]), float(got["cpu"][metric][v])) for v in variants}
            cell[metric] = max(devs.values())
            worst[metric] = max(worst.get(metric, 0.0), cell[metric])
            for v, dv in devs.items():
                if metric in gates and not dv <= gates[metric]:
                    wc = results[(i, v, None, str(dev), False)]
                    wp = results[(i, v, None, "cpu", False)]
                    lanes = [
                        (j, int(wc["status"][j]), int(wp["status"][j]), int(wc["nit"][j]), int(wp["nit"][j]))
                        for j in range(BATCH_STARTS)
                        if (wc["status"][j], wc["nit"][j]) != (wp["status"][j], wp["nit"][j])
                    ]
                    failures.append(
                        f"{p.name} / {v}: {metric} card {per[v]!r} CPU {got['cpu'][metric][v]!r}; "
                        f"lanes (j, status card/CPU, nit card/CPU) that differ: {lanes}"
                    )
        log(
            f"phase 13a [{card}]: {p.name}: largest deviation card vs CPU per metric over "
            f"{len(variants)} variants: " + ", ".join(f"{k} {v:.3g}" for k, v in cell.items())
        )
    log(
        f"phase 13a: largest deviation per metric over the m<=2 cells (gates: Error rate equal, "
        f"Hypervolume {HV_RTOL}, Avg iterations {NIT_RTOL}; the rest printed): "
        + ", ".join(f"{k} {v!r}" for k, v in worst.items())
    )
    for d, per_cell in ratios.items():
        prof = performance_profiles(per_cell)
        best = {
            metric: {alg: round(float(np.sum(tau <= 1.0)) / len(per_cell), 3) for alg, (tau, _) in algs.items()}
            for metric, algs in prof.items()
            if metric in ("Hypervolume", "Avg iterations", "Avg computation time")
        }
        log(f"phase 13a [{card}]: {d}: performance profiles over {len(per_cell)} cells, share at ratio 1: {best}")
    for f in failures:
        log(f"phase 13a: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 13a: {len(failures)} metrics differ card against CPU")


def phase13b(card: str, cli: dict) -> None:
    """The CLI's two runs (in the pool): the first solves all 15 cells,
    the second none, with byte-identical per-problem metrics.json."""
    (w1, w2), (s1, s2) = cli["walls"], cli["solved"]
    log(
        f"phase 13b [{card}]: harness CLI {' '.join(CLI_ARGS)}: first run {w1:.3f} s solved "
        f"{len(s1)} cells, second run {w2:.3f} s solved {len(s2)}; per-problem metrics.json "
        f"byte-identical: {cli['same_bytes']} ({cli['cells']} cells); end artefact "
        f"{cli['artefact']}, {cli['rows']} rows (inside the pool)"
    )
    if not (len(s1) == cli["cells"] == 15 and not s2 and cli["same_bytes"] and cli["rows"] > 0):
        raise AssertionError("phase 13b: the CLI runs do not hold")


def _ab_csv(name: str) -> dict:
    """examples/data/<name>_ab.csv: (a, b) -> (seconds per solve, mean nit)."""
    path = Path(__file__).resolve().parent / "examples" / "data" / f"{name}_ab.csv"
    out = {}
    for line in path.read_text().splitlines():
        a, b, t, n = line.split(",")
        out[(a.strip(), b.strip())] = (float(t), float(n))
    return out


def phase13c(card: str, dev, results: dict) -> None:
    """The momentum sweeps (in the pool) against the committed CSVs: every
    pair's error rate 0 and mean nit within ``AB_NIT_RTOL``; seconds per
    solve on the card beside the CSV's (the JAX package on a CPU,
    examples/data/README.md)."""
    failures = []
    for name in AB_BOXES:
        got = results[("sweep", name, str(dev))]
        ref = _ab_csv(name)
        worst = 0.0
        for r in got["rows"]:
            t_ref, n_ref = ref[(r["a"], r["b"])]
            d = math.inf if r["nit"] is None else abs(r["nit"] - n_ref) / n_ref
            worst = max(worst, d)
            log(
                f"phase 13c [{card}]: {name} (a, b) = ({r['a']}, {r['b']}): nit {r['nit']!r} "
                f"(CSV {n_ref!r}), error rate {r['error_rate']!r}, s per solve {r['time']!r} "
                f"(CSV {t_ref!r})"
            )
            if r["error_rate"] != 0 or not d <= AB_NIT_RTOL:
                failures.append(f"{name} {r['a']}, {r['b']}: nit {r['nit']} against {n_ref}")
        log(
            f"phase 13c [{card}]: {name}: {got['lanes']} lanes ({got['dtype']}), sweep and "
            f"timed pairs {got['wall']:.3f} s (inside the pool), max nit {got['nit_max']}, "
            f"largest nit deviation from the CSV {worst!r} (bound {AB_NIT_RTOL})"
        )
    for f in failures:
        log(f"phase 13c: MISMATCH {f}")
    if failures:
        raise AssertionError(f"phase 13c: {len(failures)} pairs differ from the CSVs")


def phase13d(card: str) -> None:
    """``gap_bench.run()`` at its defaults on the card: both targets
    reached, the tighter not sooner, both walls positive; the raw loop
    launches ``fista_tail``, the public pass ``lasso_step_tail`` from
    replayed chunk graphs."""
    from zfista_tpu_torch.bench import gap_bench
    from zfista_tpu_torch.ops import fused

    zero(fused.launch_counts)
    replays = graph_replays()
    rec = gap_bench.run()
    torch.cuda.synchronize()
    launched = dict(fused.launch_counts)
    replays = graph_replays() - replays
    log(f"phase 13d [{card}]: gap_bench.run(): {json.dumps(rec)}; kernel launches {launched}; "
        f"the public pass's chunks: {replays} graph replays")
    rows = {r["target"]: r for r in rec["rows"]}
    ok = (
        all(r["iterations"] is not None and r["raw_s"] > 0 and r["public_s"] > 0 for r in rows.values())
        and rows[1e-8]["iterations"] >= rows[1e-6]["iterations"]
        and launched["fista_tail"] > 0
        and launched["lasso_step_tail"] > 0
        and replays > 0
    )
    if not ok:
        raise AssertionError("phase 13d: a gap target was not reached")


def phase13e(card: str) -> None:
    """``restart_bench.main(["--repeats", "1", "--skip", "tridia"])`` on the
    card: every row status 1 (the TV row without restart may instead run
    to max_iter, and is then held to the restart row's F), each pair's F
    within ``RESTART_FRTOL``; the
    rows without restart launch ``lasso_step_tail`` and the TV prox the
    whole-image FGP kernel."""
    from zfista_tpu_torch.bench import restart_bench
    from zfista_tpu_torch.ops import fused, tv_cuda

    zero(fused.launch_counts)
    zero(tv_cuda.launch_counts)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        restart_bench.main(["--repeats", "1", "--skip", "tridia"])
    torch.cuda.synchronize()
    launched = {**fused.launch_counts, **tv_cuda.launch_counts}
    for line in buf.getvalue().splitlines():
        log(f"phase 13e [{card}]: {line}")
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    log(f"phase 13e: kernel launches {launched}")
    pairs: dict[str, dict] = {}
    for r in rows:
        pairs.setdefault(r["problem"], {})[r["restart"]] = r
    # Plain FISTA on the TV row may end at max_iter (2,000) in float32:
    # the JAX package records the same on its accelerator (BENCHMARKS.md,
    # "Adaptive restart": never converges at tol 1e-6), while the port on
    # the CPU converges there. Such a row must still reach the restart
    # row's F within RESTART_FRTOL; every other row converges.
    ok = len(rows) == 4 and set(pairs) == {"lasso_n10k", "tv_deblur_256"}
    for name, pair in pairs.items():
        if set(pair) != {False, True}:
            ok = False
            continue
        dev_f = _rel(pair[False]["F"], pair[True]["F"])
        stalled = [r for r in pair.values() if r["status"] != 1]
        allowed = all(
            name == "tv_deblur_256" and not r["restart"] and r["status"] == 0
            and r["nit"] == 2000
            for r in stalled
        )
        ok = ok and allowed and dev_f <= RESTART_FRTOL
        log(
            f"phase 13e: {name}: F without/with restart {dev_f:.3e} relative "
            f"(bound {RESTART_FRTOL}); rows at max_iter held to it: "
            f"{len(stalled)}{'' if allowed else ' (not allowed)'}"
        )
    if not (ok and launched["lasso_step_tail"] > 0 and launched["fgp_resident"] > 0):
        raise AssertionError("phase 13e: the restart rows do not hold")


def phase13f(card: str, dev, A, b, lr: float) -> None:
    """Checkpoint and profiling on the card: a fixed-step LASSO solve at
    full width stopped at ``CKPT_STOP`` iterations, saved, loaded and
    resumed to ``CKPT_END`` is bitwise the uninterrupted solve; a JOS1
    batch's State round-trips and resumes bitwise; ``TVDeblur``'s
    checkpoint metadata round-trips; ``trace`` around ``TRACE_STEPS`` steps
    in an ``annotate`` scope holds the scope and ``lasso_step_tail``."""
    from zfista_tpu_torch.bench import tv_bench
    from zfista_tpu_torch.models import JOS1, Lasso, TVDeblur
    from zfista_tpu_torch.utils.checkpoint import load_meta, load_state, save_state
    from zfista_tpu_torch.utils.profiling import annotate, trace

    def same(s1, s2) -> bool:
        return all(np.array_equal(u, v) and u.dtype == v.dtype for u, v in zip(s1, s2))

    prob = Lasso(A, b, LAM)
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, tol=0)
    with tempfile.TemporaryDirectory() as tmp:
        full = prob.solve_fixed_step(x0, max_iter=CKPT_END, **kw)
        part = prob.solve_fixed_step(x0, max_iter=CKPT_STOP, **kw)
        save_state(part.state, Path(tmp) / "lasso")
        loaded = load_state(Path(tmp) / "lasso")
        resumed = prob.solve_fixed_step(x0, max_iter=CKPT_END, initial_state=loaded, **kw)
        lasso_ok = loaded.x.device.type == dev.type and same(resumed.state, full.state) and resumed.nit == CKPT_END

        p = JOS1(n_features=5)
        x0s = torch.tensor(np.random.default_rng(42).uniform(-2.0, 4.0, (64, 5)), device=dev)
        whole = p.solve_batch(x0s, nesterov=True)
        head = p.solve_batch(x0s, nesterov=True, max_iter=5)
        save_state(head.state, Path(tmp) / "batch.npz")
        back = load_state(Path(tmp) / "batch.npz")
        tail = p.solve_batch(x0s, nesterov=True, initial_states=back)
        batch_ok = same([v.cpu().numpy() for v in back], head.state) and same(tail.state, whole.state)

        kernel, observed = tv_bench.scene(CAMERAMAN, dev)
        tv = TVDeblur(torch.as_tensor(observed, dtype=torch.float32, device=dev), kernel=kernel)
        meta = tv.checkpoint_meta()
        save_state(tv.solve(max_iter=5, tol=0).state, Path(tmp) / "tv", meta=meta)
        meta_ok = load_meta(Path(tmp) / "tv") == meta

        with trace(Path(tmp) / "prof"):
            with annotate("zt.lasso"):
                prob.solve_fixed_step(x0, max_iter=TRACE_STEPS, **kw)
        (path,) = (Path(tmp) / "prof").glob("trace_*.json")
        names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
        trace_ok = "zt.lasso" in names and any("lasso_step_tail" in n for n in names)
        trace_mb = path.stat().st_size / 1e6
    log(
        f"phase 13f [{card}]: LASSO m={M} n={N} f32 stopped at {CKPT_STOP}, saved, loaded on "
        f"{loaded.x.device} and resumed to {CKPT_END}: bitwise the uninterrupted solve (x and "
        f"every State field): {lasso_ok}; JOS1 batch of 64 (State round-trip, resume from "
        f"iteration 5): bitwise {batch_ok}; TVDeblur {CAMERAMAN}x{CAMERAMAN} meta {meta} "
        f"round-trips: {meta_ok}; trace of {TRACE_STEPS} steps ({trace_mb:.1f} MB) holds "
        f"'zt.lasso' and lasso_step_tail: {trace_ok}"
    )
    if not (lasso_ok and batch_ok and meta_ok and trace_ok):
        raise AssertionError("phase 13f: checkpoint or profiling does not hold")


def phase13g(card: str) -> None:
    """The port's native metrics kernels (g++ from its own metrics.cpp)
    against its numpy paths on numpy-seeded 3-objective data."""
    from zfista_tpu_torch import metrics, native

    lib = native.load()
    if lib is None:
        raise AssertionError("phase 13g: the native metrics library did not build or load")
    rng = np.random.default_rng(7)
    F = rng.uniform(0.0, 1.0, size=(ND_POINTS, 3))
    t0 = time.perf_counter()
    got = native.nd_mask_native(F)
    t_mask = time.perf_counter() - t0
    want = ~(np.all(F[:, None, :] <= F[None, :, :], -1) & np.any(F[:, None, :] < F[None, :, :], -1)).any(0)
    P = np.abs(rng.standard_normal((HV_POINTS, 3)))
    P = 1.0 - 0.9 * P / np.linalg.norm(P, axis=1, keepdims=True)
    t0 = time.perf_counter()
    hv = native.hypervolume_native(P, np.ones(3))
    t_hv = time.perf_counter() - t0
    t0 = time.perf_counter()
    hv_py = float(metrics._wfg(P, np.ones(3)))
    t_py = time.perf_counter() - t0
    rel = _rel(hv, hv_py)
    log(
        f"phase 13g [{card}]: native metrics loaded ({lib._name}, built by g++ at its first use); "
        f"non_dominated_mask on {ND_POINTS} points equal to numpy: {np.array_equal(got, want)} "
        f"({int(got.sum())} on the front, {t_mask * 1e3:.2f} ms); hypervolume of a {HV_POINTS}-point "
        f"front {hv!r} against the Python WFG's {hv_py!r}, relative {rel!r} (bound 1e-12; "
        f"{t_hv * 1e3:.2f} ms against {t_py:.2f} s)"
    )
    if not (np.array_equal(got, want) and bool(metrics.non_dominated_mask(P).all()) and rel <= 1e-12):
        raise AssertionError("phase 13g: native metrics differ from the numpy paths")


#: Phase 14a-b: examples/cameraman_deblur.py's workload (the synthetic
#: cameraman of side WL_SIDE, Gaussian 9x9 sigma=4, l1_ratio 2e-5, lr 1/L,
#: tol 1e-5, max_iter 2000) and the momentum pair WaveletDeblur.solve
#: defaults to.
WL_L1, WL_TOL, WL_MAX_ITER, WL_PAIR = 2e-5, 1e-5, 2000, ("0", "1/4")
#: Bounds of the wavelet gates against the float64 CPU solve: F relative
#: (every one of the 15 pairs solves the same convex problem, so each of
#: 14b's lanes is held to it too), PSNR against the truth in dB.
WL_FRTOL, WL_PSNR_DB = 1e-4, 0.05
#: Bounds on the iteration counts of the wavelet solves.  At tol 1e-5 the
#: count is decided at the rounding floor of the largest coefficients
#: (~128 x float32's 6e-8, near the tolerance itself).  On a CPU in float32
#: (wavelet_nit_spread: each pair from the DWT start and four starts moved
#: by one ulp), a pair's counts spread by up to 20% and lie up to 16% from
#: the CSV's (a TPU's float32 run); in float64 the default pair's run from
#: 1,045 to 1,182.  So one count is held within WL_NIT_RTOL, and the 15
#: pairs' mean, where the spread averages out (1.1-2.8% from the CSV's mean
#: in that run), within WL_MEAN_RTOL.
WL_NIT_RTOL, WL_MEAN_RTOL = 0.25, 0.06
#: Phase 14c: the sparse logistic regression.  A (m x n) standard normal,
#: a planted classifier with LOGISTIC_NNZ standard normal weights, labels
#: sign(A w + LOGISTIC_NOISE * noise), numpy seed 0; lambda LOGISTIC_LAM
#: (the solution has ~143 nonzeros).
LOGISTIC_SHAPE, LOGISTIC_NNZ, LOGISTIC_NOISE, LOGISTIC_LAM = (2000, 10_000), 20, 0.5, 0.01
#: KKT residual bound, card-vs-CPU windows (iterations), and the float32
#: accept-test slack relative to |F| (the facade's tol_internal_rel, its
#: documented float32 rescue: without it a float32 line search near the
#: optimum rejects trials on rounding noise and shrinks lr).
KKT_TOL, MODEL_WINDOW, F32_ACCEPT_REL = 1e-4, 50, 1e-6
#: KKT bound of the float32 backtracking default solve.  Its stopping test
#: (||x+ - y||_inf < tol = 1e-5) bounds the residual only by ~tol / lr, and
#: without the accept slack its line search shrinks lr on rounding noise:
#: KKT 7.58e-5 at lr 2^-7 on a CPU, 1.0036e-4 at 2^-8 on an H100, against
#: 1.26e-5 at lr 1/2 in float64 (PERF.md, PR 8).  So KKT_TOL holds for the
#: slack and fixed-step solves, and the default is held to twice it.
KKT_TOL_F32_DEFAULT = 2e-4
#: Bound on each float32 solve's F of (c) and (d) against the float64 CPU
#: solve's, relative (on a CPU in float32: logistic 2.0e-6, group LASSO
#: 9.8e-6 from its stalled line search).
MODEL_FRTOL = 1e-4
#: Phase 14d: group LASSO on the LASSO problem of the module, groups of 10.
GROUP_SIZE, GROUP_TOL = 10, 1e-6
#: Phase 14e: the arguments of the two kernel benches.
KERNELS_BENCH_ARGS: list[str] = []
TV_BENCH_ARGS = ["--sizes", "256,2048"]


def chunk_of(check_every: int | None, dev) -> int:
    """The steps a fixed-step single-objective solve runs per host read:
    ``check_every``, or by default 64 on a card and 1 on the CPU.  A solve
    that stops at ``nit`` has launched its step ``nit`` rounded up to
    that."""
    if check_every is not None:
        return check_every
    return 64 if torch.device(dev).type == "cuda" else 1


def cameraman_scene(dtype: torch.dtype, device) -> tuple:
    """examples/cameraman_deblur.py's scene: the truth, the Gaussian 9x9
    sigma=4 kernel, and the observation (the truth blurred on ``device``),
    in ``dtype``."""
    from zfista_tpu_torch.models import deblur as td

    truth = td.synthetic_cameraman(WL_SIDE, dtype=dtype, device=device)
    kernel = td.gaussian_kernel(9, 4.0)
    return truth, kernel, td.make_blur(kernel)(truth)


def wavelet_psnr(x, levels: int, truth: np.ndarray) -> float:
    """PSNR of the image that the coefficients ``x`` reconstruct."""
    from zfista_tpu_torch.models.deblur import idwt2

    rec = idwt2(torch.as_tensor(np.asarray(x, np.float64)).reshape(truth.shape), levels)
    return psnr(rec.numpy(), truth)


def wavelet_cpu() -> dict:
    """(a)'s reference, in a worker: the same solve in float64 on the CPU
    (to the end, and the first ``AGREE_ITERS`` iterations at tol 0)."""
    from zfista_tpu_torch.models import WaveletDeblur

    truth, kernel, observed = cameraman_scene(torch.float64, "cpu")
    prob = WaveletDeblur(observed, l1_ratio=WL_L1, kernel=kernel)
    t0 = time.perf_counter()
    res = prob.solve(tol=WL_TOL, max_iter=WL_MAX_ITER)
    wall = time.perf_counter() - t0
    window = quiet(prob.solve, tol=0, max_iter=AGREE_ITERS)
    return dict(
        nit=res.nit, status=res.status, fun=float(res.fun[0]), wall=wall,
        psnr=wavelet_psnr(res.x, prob.levels, truth.numpy()), window=window.x,
    )


def wavelet_windows() -> np.ndarray:
    """(b)'s reference, in a worker: the first ``AGREE_ITERS`` iterations
    (tol 0) of (a)'s solve in float64 on the CPU for each of the 15
    momentum pairs, one single solve each; rows in ``AB_GRID`` order."""
    from zfista_tpu_torch.bench.momentum_sweep import AB_GRID
    from zfista_tpu_torch.models import WaveletDeblur

    _, kernel, observed = cameraman_scene(torch.float64, "cpu")
    prob = WaveletDeblur(observed, l1_ratio=WL_L1, kernel=kernel)
    return np.stack([
        quiet(prob.solve, tol=0, max_iter=AGREE_ITERS, nesterov_ratio=(float(a), float(b))).x
        for a, b in AB_GRID
    ])


def ulp_moved(x: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """``x`` with each entry moved by one unit in the last place of its
    dtype, up or down at random."""
    up = torch.as_tensor(rng.random(x.shape) < 0.5, device=x.device)
    inf = torch.full_like(x, math.inf)
    return torch.nextafter(x, torch.where(up, inf, -inf))


def wavelet_nit_spread(dtype=torch.float32, members: int = 4, pairs=None, seed: int = 5) -> dict:
    """The iteration counts of (a)'s solve on the CPU, for each momentum pair
    of ``pairs`` (default all 15), in ``dtype``, from the DWT start and from
    ``members`` starts each of whose entries is moved by one unit in the
    last place (:func:`ulp_moved`, numpy ``seed``): how far the rounding
    floor alone moves a count.  Returns {(a, b): [counts]}; run it
    on the CPU as ``python3 -c "import chip_smoke as c;
    print(c.wavelet_nit_spread())"`` (about 6 s per solve per thread)."""
    from zfista_tpu_torch.bench.momentum_sweep import AB_GRID
    from zfista_tpu_torch.models import WaveletDeblur

    _, kernel, observed = cameraman_scene(torch.float64, "cpu")
    prob = WaveletDeblur(observed.to(dtype), l1_ratio=WL_L1, kernel=kernel)
    x0 = prob.x0()
    rng = np.random.default_rng(seed)
    out = {}
    for a, b in AB_GRID if pairs is None else pairs:
        starts = [x0] + [ulp_moved(x0, rng) for _ in range(members)]
        out[(str(a), str(b))] = [
            prob.solve(x0=s, tol=WL_TOL, max_iter=WL_MAX_ITER,
                       nesterov_ratio=(float(a), float(b))).nit
            for s in starts
        ]
    return out


def cameraman_sweep(device: str) -> dict:
    """(b), in a worker: ``python -m zfista_tpu_torch.examples.cameraman_deblur``
    with ``--out`` in a temporary directory."""
    from zfista_tpu_torch.examples import cameraman_deblur

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rows, res = cameraman_deblur.main(["--out", tmp, "--device", device])
        wall = time.perf_counter() - t0
        written = sorted(p.name for p in Path(tmp).iterdir())
    return dict(rows=rows, nit=res.nit, status=res.status, fun=np.reshape(res.fun, -1),
                wall=wall, written=written, stdout=buf.getvalue())


def logistic_problem() -> tuple[np.ndarray, np.ndarray]:
    """Phase 14c's data, float32: A and the +-1 labels."""
    m, n = LOGISTIC_SHAPE
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, n))
    w = np.zeros(n)
    w[rng.choice(n, LOGISTIC_NNZ, replace=False)] = rng.standard_normal(LOGISTIC_NNZ)
    y = np.sign(A @ w + LOGISTIC_NOISE * rng.standard_normal(m))
    return A.astype(np.float32), y.astype(np.float32)


def model_problem(name: str, device, dtype: torch.dtype):
    """(c)'s ``SparseLogistic`` or (d)'s ``GroupLasso`` on ``device`` in
    ``dtype``."""
    from zfista_tpu_torch.models import GroupLasso, SparseLogistic

    if name == "logistic":
        A, y = logistic_problem()
        return SparseLogistic(torch.tensor(A, dtype=dtype, device=device),
                              torch.tensor(y, dtype=dtype, device=device), LOGISTIC_LAM)
    A, b = make_problem()
    return GroupLasso(torch.tensor(A, dtype=dtype, device=device),
                      torch.tensor(b, dtype=dtype, device=device), LAM, GROUP_SIZE)


def model_solve(name: str, prob, **kw):
    """(c)'s and (d)'s backtracking solve (Nesterov; the group LASSO from
    zeros to ``GROUP_TOL``), with the options ``kw``."""
    if name == "logistic":
        return prob.solve(**kw)
    kw.setdefault("tol", GROUP_TOL)
    return prob.solve(torch.zeros(N, dtype=prob.A.dtype, device=prob.A.device),
                      nesterov=True, **kw)


def model_windows(name: str, device: str, dtype: torch.dtype, lr: float | None) -> dict:
    """The first ``MODEL_WINDOW`` iterations (tol 0) of (c)'s and (d)'s
    solves on ``device`` in ``dtype``: the backtracking solve, and for the
    logistic model the fixed step at ``lr``.  Returns each one's x, nit and
    trial count."""
    prob = model_problem(name, device, dtype)
    kw = dict(tol=0, max_iter=MODEL_WINDOW)
    runs = {"backtracking": quiet(model_solve, name, prob, **kw)}
    if name == "logistic":
        runs["fixed"] = quiet(prob.solve, decay_rate=1, lr=lr, **kw)
    return {k: dict(x=r.x, nit=r.nit, nit_internal=r.nit_internal) for k, r in runs.items()}


def model_cpu(name: str) -> dict:
    """(c)'s and (d)'s reference, in a worker: the backtracking default
    solve in float64 on the CPU."""
    prob = model_problem(name, "cpu", torch.float64)
    t0 = time.perf_counter()
    res = model_solve(name, prob)
    return dict(status=res.status, nit=res.nit, fun=float(res.fun[0]),
                wall=time.perf_counter() - t0)


def phase14_tasks(dev, card14: dict) -> list:
    """Phase 14's pool work: (b)'s sweep on the card, and the CPU float64
    references of (a), (c) and (d)."""
    return [
        ("cameraman_sweep", str(dev)),
        ("wavelet_cpu",),
        ("wavelet_windows",),
        ("model_cpu", "logistic"),
        ("model_cpu", "group_lasso"),
        ("windows", "logistic", card14.get("logistic_lr")),
        ("windows", "group_lasso", None),
    ]


def phase14a(card: str, dev) -> dict:
    """The cameraman solve on the card, float32: ``WaveletDeblur.solve()``
    (default pair (0, 1/4), ``check_every`` 64 on a card), then with
    ``check_every`` 8 and 1 (bitwise equal), each launching
    ``lasso_step_tail`` once per step run; the first ``AGREE_ITERS``
    iterations; two starts moved by one ulp (printed); and (b)'s 15 pairs
    as one batch over the first ``AGREE_ITERS`` iterations, through the
    example's ``momentum_sweep`` (held against the CPU later)."""
    from zfista_tpu_torch.bench.momentum_sweep import momentum_sweep
    from zfista_tpu_torch.models import WaveletDeblur
    from zfista_tpu_torch.ops import fused

    truth, kernel, observed = cameraman_scene(torch.float32, dev)
    prob = WaveletDeblur(observed, l1_ratio=WL_L1, kernel=kernel)
    runs, walls, launches, replays, capture_ms = {}, {}, {}, {}, {}
    for ce in (None, 8, 1):
        counts = graph_counts()
        before = graph_replays()
        zero(fused.launch_counts)  # a main-path solve starts here
        t0 = time.perf_counter()
        runs[ce] = prob.solve(tol=WL_TOL, max_iter=WL_MAX_ITER, check_every=ce)
        torch.cuda.synchronize()
        walls[ce] = time.perf_counter() - t0
        launches[ce] = fused.launch_counts["lasso_step_tail"]  # ... and ends here
        replays[ce] = graph_replays() - before
        if graphs_since(counts)["captures"]:
            capture_ms[chunk_of(ce, dev)] = last_capture_ms(counts)
    # The solve again, on the cached graph, and with its chunks launched
    # eagerly (the driver before the graphs): wall per step of each.
    for ce, label in ((None, "graph, repeat"), ("eager", "eager chunks of 64")):
        t0 = time.perf_counter()
        with eager_chunks() if ce == "eager" else contextlib.nullcontext():
            again = prob.solve(tol=WL_TOL, max_iter=WL_MAX_ITER)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        same_state(again.state, runs[1].state, f"phase 14a: the {label} solve against check_every=1")
    res = runs[None]
    steps = {ce: -(-runs[ce].nit // chunk_of(ce, dev)) * chunk_of(ce, dev) for ce in runs}
    log(
        f"phase 14a [{card}]: WaveletDeblur(cameraman {WL_SIDE}x{WL_SIDE} f32, l1_ratio {WL_L1}, "
        f"levels {prob.levels}).solve(tol={WL_TOL}, max_iter={WL_MAX_ITER}): status={res.status} "
        f"nit={res.nit} fun={float(res.fun[0])!r} lr={res.lr!r} wall {walls[None]:.3f} s "
        f"({1e3 * walls[None] / steps[None]:.3f} ms per step run); lasso_step_tail launches "
        f"by check_every {launches} against steps run {steps}; walls "
        f"{ {str(k): round(v, 3) for k, v in walls.items()} } s"
    )
    if res.status != 1 or not np.all(np.isfinite(res.x)) or res.x.shape != (WL_SIDE**2,):
        raise AssertionError("phase 14a: the cameraman solve did not converge")
    if launches != steps:
        raise AssertionError(f"phase 14a: lasso_step_tail launches {launches} != steps {steps}")
    chunks = {ce: steps[ce] // chunk_of(ce, dev) for ce in runs}
    log(f"phase 14a: chunk-graph replays by check_every {replays} (chunks {chunks}: the first "
        f"ran eagerly and was captured); the captures by chunk length {capture_ms} ms of host time")
    if replays != {None: chunks[None] - 1, 8: chunks[8] - 1, 1: 0}:
        raise AssertionError(f"phase 14a: graph replays {replays} for chunks {chunks}")
    for ce in (8, None):
        same_state(runs[ce].state, runs[1].state, f"phase 14a: check_every={ce} against 1")
    log("phase 14a: check_every=8 and 64 (replayed graphs), the repeat on the cached graph and "
        "eager chunks of 64 are bitwise equal to check_every=1 (x, nit, State); wall per step "
        f"run: graph {1e3 * walls[None] / steps[None]:.3f} ms (with the capture), graph repeat "
        f"{1e3 * walls['graph, repeat'] / steps[None]:.3f} ms, eager chunks "
        f"{1e3 * walls['eager chunks of 64'] / steps[None]:.3f} ms, check_every=1 "
        f"{1e3 * walls[1] / steps[1]:.3f} ms")
    window = quiet(prob.solve, tol=0, max_iter=AGREE_ITERS)
    rng = np.random.default_rng(5)
    spread = [
        prob.solve(x0=ulp_moved(prob.x0(), rng), tol=WL_TOL, max_iter=WL_MAX_ITER).nit
        for _ in range(2)
    ]
    log(f"phase 14a [{card}]: the same solve from two starts moved by one ulp: nit {spread}")
    sweep_window = quiet(
        momentum_sweep, prob, 0.0, 0.0, n_starts=1, x0s=prob.x0().cpu().numpy()[None, :],
        measure_times=False, nesterov=True, lr=1.0 / prob.lipschitz(), decay_rate=1, tol=0,
        max_iter=AGREE_ITERS, check_every=8, device=dev,
    )[1]
    return dict(
        wl_sweep_window=np.asarray(sweep_window.x, np.float64),
        wl_nit=res.nit, wl_fun=float(res.fun[0]), wl_levels=prob.levels,
        wl_psnr=wavelet_psnr(res.x, prob.levels, truth.double().cpu().numpy()),
        wl_window=window.x, wl_launches=launches[None], wl_wall_per_step=walls[None] / steps[None],
        wl_walls_per_step={k: v / steps[None] for k, v in walls.items() if k not in (8, 1)},
    )


def phase14c(card: str, dev) -> dict:
    """``SparseLogistic`` on the card, float32: the backtracking default
    (KKT residual at most ``KKT_TOL_F32_DEFAULT``), the backtracking solve
    with the float32 accept slack ``F32_ACCEPT_REL`` and the fixed step
    ``decay_rate=1, lr=1/L`` (each at most ``KKT_TOL``); the fixed step
    launches ``lasso_step_tail`` once per step run; each F and the first
    ``MODEL_WINDOW`` iterations in float32 and in float64 are held against
    the CPU later."""
    from zfista_tpu_torch.ops import fused

    prob = model_problem("logistic", dev, torch.float32)
    lr = 1.0 / prob.lipschitz()
    runs, walls = {}, {}
    for name, kw in (("default", {}), ("f32 accept slack", dict(tol_internal_rel=F32_ACCEPT_REL)),
                     ("fixed", dict(decay_rate=1, lr=lr))):
        zero(fused.launch_counts)
        t0 = time.perf_counter()
        runs[name] = prob.solve(**kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        r = runs[name]
        log(
            f"phase 14c [{card}]: SparseLogistic({LOGISTIC_SHAPE[0]}x{LOGISTIC_SHAPE[1]} f32, "
            f"lambda {LOGISTIC_LAM}).solve({kw}): status={r.status} nit={r.nit} "
            f"nit_internal={r.nit_internal} lr={r.lr!r} fun={float(r.fun[0])!r} nonzeros "
            f"{int(np.sum(r.x != 0))} kkt_residual {prob.kkt_residual(r.x)!r} wall {walls[name]:.3f} s; "
            f"kernel launches {dict(fused.launch_counts)}"
        )
    # The backtracking solves' carried trials on replayed graphs.
    for name, kw in (("default", {}), ("f32 accept slack", dict(tol_internal_rel=F32_ACCEPT_REL))):
        ref = held_at_64(card, f"phase 14c: SparseLogistic.solve({kw})", prob.solve, **kw)
        same_result(runs[name], ref, f"phase 14c: the {name} solve against check_every=1")
    fixed = runs["fixed"]
    steps = -(-fixed.nit // chunk_of(None, dev)) * chunk_of(None, dev)
    launched = fused.launch_counts["lasso_step_tail"]
    replays = graph_replays()
    t0 = time.perf_counter()
    per_step = prob.solve(decay_rate=1, lr=lr, check_every=1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = prob.solve(decay_rate=1, lr=lr)
    torch.cuda.synchronize()
    wall_again = time.perf_counter() - t0
    replays = graph_replays() - replays
    same_state(fixed.state, per_step.state, "phase 14c: the graphed fixed step against check_every=1")
    same_state(again.state, per_step.state, "phase 14c: the repeat on the cached graph against check_every=1")
    log(
        f"phase 14c [{card}]: the fixed-step solve (check_every 64, replayed graphs) and its repeat "
        f"on the cached graph ({replays} replays) are bitwise check_every=1 in every State field; "
        f"wall per step run: graph {1e3 * walls['fixed'] / steps:.3f} ms (with the capture), repeat "
        f"{1e3 * wall_again / steps:.3f} ms, check_every=1 {1e3 * wall1 / fixed.nit:.3f} ms"
    )
    if replays != steps // chunk_of(None, dev):
        raise AssertionError(f"phase 14c: {replays} graph replays for {steps} steps")
    for name, r in runs.items():
        bound = KKT_TOL_F32_DEFAULT if name == "default" else KKT_TOL
        if r.status != 1 or not prob.kkt_residual(r.x) <= bound:
            raise AssertionError(f"phase 14c: the {name} solve misses the KKT bound {bound}")
        if not 10 <= int(np.sum(r.x != 0)) <= 1000:
            raise AssertionError(f"phase 14c: the {name} solve has {int(np.sum(r.x != 0))} nonzeros")
    if launched != steps:
        raise AssertionError(f"phase 14c: lasso_step_tail launched {launched} in {steps} steps")
    return dict(
        logistic_lr=lr, logistic_launches=launched,
        logistic_wall_per_step=walls["fixed"] / steps,
        logistic_funs={k: float(r.fun[0]) for k, r in runs.items()},
        logistic_f32=model_windows("logistic", str(dev), torch.float32, lr),
        logistic_f64=model_windows("logistic", str(dev), torch.float64, lr),
    )


def phase14d(card: str, dev) -> dict:
    """``GroupLasso`` on the module's LASSO problem, groups of
    ``GROUP_SIZE``, backtracking: float32 converges to ``GROUP_TOL``, with
    and without the float32 accept slack (each F held against the CPU
    later); the first ``MODEL_WINDOW`` float64 iterations (held against
    the CPU later)."""
    prob = model_problem("group_lasso", dev, torch.float32)
    runs = {}
    for name, kw in (("default", {}), ("f32 accept slack", dict(tol_internal_rel=F32_ACCEPT_REL))):
        t0 = time.perf_counter()
        r = runs[name] = model_solve("group_lasso", prob, **kw)
        torch.cuda.synchronize()
        groups = int(np.sum(np.abs(r.x.reshape(-1, GROUP_SIZE)).sum(1) > 0))
        log(
            f"phase 14d [{card}]: GroupLasso(m={M}, n={N} f32, lambda {LAM}, group_size "
            f"{GROUP_SIZE}).solve(nesterov=True, tol={GROUP_TOL}, {kw}): status={r.status} "
            f"nit={r.nit} nit_internal={r.nit_internal} lr={r.lr!r} fun={float(r.fun[0])!r} "
            f"nonzero groups {groups} wall {time.perf_counter() - t0:.3f} s"
        )
    for name, r in runs.items():
        if r.status != 1 or not np.all(np.isfinite(r.x)):
            raise AssertionError(f"phase 14d: the float32 group-LASSO {name} solve did not converge")
    # The backtracking solves' carried trials on replayed graphs.
    for name, kw in (("default", {}), ("f32 accept slack", dict(tol_internal_rel=F32_ACCEPT_REL))):
        ref = held_at_64(card, f"phase 14d: GroupLasso.solve({kw})", partial(model_solve, "group_lasso", prob), **kw)
        same_result(runs[name], ref, f"phase 14d: the {name} solve against check_every=1")
    return dict(group_f64=model_windows("group_lasso", str(dev), torch.float64, None),
                group_funs={k: float(r.fun[0]) for k, r in runs.items()})


def phase14e(card: str) -> None:
    """The two kernel benches on the card (their bitwise checks raise)."""
    from zfista_tpu_torch.bench import kernels, tv_bench

    for name, main_, argv in (("kernels", kernels.main, KERNELS_BENCH_ARGS),
                              ("tv_bench", tv_bench.main, TV_BENCH_ARGS)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main_(argv)
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"phase 14e [{card}]: bench.{name}: {line}")
        log(f"phase 14e: bench.{name}.main({argv}) in {time.perf_counter() - t0:.1f} s; "
            "kernel against plain bitwise: held")


def phase14(card: str, dev, card14: dict, results: dict, parts=("14a", "14b", "14c", "14d")) -> None:
    """Phase 14's comparisons, after the pool, for ``parts``: (a) the card's
    cameraman solve against the float64 CPU solve and the CSV, and its
    launches per step by torch.profiler; (b) the 15-pair sweep against the
    CSV; (c) and (d) the card's windows against the CPU's."""
    csv = _ab_csv("cameraman")
    if "14a" in parts:
        phase14a_cpu(card, dev, card14, results, csv)
    if "14b" in parts:
        phase14b(card, dev, card14, results, csv)
    models = [m for m, part in (("logistic", "14c"), ("group_lasso", "14d")) if part in parts]
    phase14cd(card14, results, models)


def phase14a_cpu(card: str, dev, card14: dict, results: dict, csv: dict) -> None:
    """(a) after the pool: the card's solve against the float64 CPU solve
    and the CSV; device events per step, eager and graphed."""
    from zfista_tpu_torch.models import WaveletDeblur

    ref = results[("wavelet_cpu",)]
    d_nit = abs(card14["wl_nit"] - ref["nit"]) / ref["nit"]
    d_csv = abs(card14["wl_nit"] - csv[WL_PAIR][1]) / csv[WL_PAIR][1]
    d_f = _rel(card14["wl_fun"], ref["fun"])
    d_psnr = abs(card14["wl_psnr"] - ref["psnr"])
    d_win = float(np.linalg.norm(card14["wl_window"] - ref["window"]) / np.linalg.norm(ref["window"]))
    log(
        f"phase 14a: card f32 against CPU f64: nit {card14['wl_nit']} vs {ref['nit']} ({d_nit:.3f}, "
        f"bound {WL_NIT_RTOL}; CSV {csv[WL_PAIR][1]}: {d_csv:.3f}), F {card14['wl_fun']!r} vs "
        f"{ref['fun']!r} ({d_f:.3e}, bound {WL_FRTOL}), PSNR {card14['wl_psnr']:.4f} vs "
        f"{ref['psnr']:.4f} dB ({d_psnr:.4f}, bound {WL_PSNR_DB}); first {AGREE_ITERS} "
        f"iterations: x relative 2-norm diff {d_win!r} (bound {AGREE_RTOL}); the CPU solve "
        f"{ref['wall']:.3f} s (one thread, in the pool)"
    )
    if not (d_nit <= WL_NIT_RTOL and d_csv <= WL_NIT_RTOL and d_f <= WL_FRTOL
            and d_psnr <= WL_PSNR_DB and d_win <= AGREE_RTOL):
        raise AssertionError("phase 14a: the cameraman solve disagrees with the CPU or the CSV")
    truth, kernel, observed = cameraman_scene(torch.float32, dev)
    prob = WaveletDeblur(observed, l1_ratio=WL_L1, kernel=kernel)
    n_events, busy = device_events(lambda: quiet(prob.solve, tol=0, max_iter=64))
    log(
        f"phase 14a [{card}]: torch.profiler over a 64-step solve (one chunk: eager): "
        f"{n_events / 64:.2f} device events per step ({n_events} with the set-up), busy "
        f"{busy / 64:.1f} us per step; wall per step run without the profiler "
        f"{ {str(k): round(1e3 * v, 3) for k, v in card14['wl_walls_per_step'].items()} } ms"
    )
    quiet(prob.solve, tol=0, max_iter=256)  # the capture, outside the profile
    n_events, busy = device_events(lambda: quiet(prob.solve, tol=0, max_iter=256))
    log(
        f"phase 14a [{card}]: torch.profiler over a 256-step solve on its cached graph (three "
        f"replays): {n_events / 256:.2f} device events per step ({n_events} with the set-up), "
        f"busy {busy / 256:.1f} us per step"
    )


def phase14b(card: str, dev, card14: dict, results: dict, csv: dict) -> None:
    """(b) after the pool: the 15-pair sweep against the CSV and (a)'s CPU
    solve, and its 15 lanes' first iterations against the CPU's."""
    ref = results[("wavelet_cpu",)]
    sweep = results[("cameraman_sweep", str(dev))]
    nits, fails = [], []
    if len(sweep["fun"]) != len(sweep["rows"]):
        raise AssertionError(f"phase 14b: {len(sweep['fun'])} lanes for {len(sweep['rows'])} pairs")
    for r, fun in zip(sweep["rows"], sweep["fun"]):  # one lane per pair, in grid order
        n_ref = csv[(r["a"], r["b"])][1]
        d = math.inf if r["nit"] is None else abs(r["nit"] - n_ref) / n_ref
        d_fun = _rel(float(fun), ref["fun"])
        nits.append(math.nan if r["nit"] is None else r["nit"])
        log(
            f"phase 14b [{card}]: (a, b) = ({r['a']}, {r['b']}): nit {r['nit']!r} (CSV {n_ref!r}, "
            f"{d:.3f}), F {float(fun)!r} against the CPU f64 solve's ({d_fun:.3e}, bound "
            f"{WL_FRTOL}), error rate {r['error_rate']!r}, s per solve on the card {r['time']!r}"
        )
        if r["error_rate"] != 0 or not d <= WL_NIT_RTOL or not d_fun <= WL_FRTOL:
            fails.append(f"({r['a']}, {r['b']}): nit {r['nit']} against {n_ref}, F {d_fun:.3e}")
    cpu_windows = results[("wavelet_windows",)]
    card_windows = card14["wl_sweep_window"]
    for i, r in enumerate(sweep["rows"]):
        dist = [float(np.linalg.norm(card_windows[i] - w) / np.linalg.norm(w)) for w in cpu_windows]
        own, other = dist[i], min(d for j, d in enumerate(dist) if j != i)
        log(
            f"phase 14b [{card}]: (a, b) = ({r['a']}, {r['b']}): lane {i} of the batch, first "
            f"{AGREE_ITERS} iterations against its pair's float64 CPU single solve: x relative "
            f"{own!r} (bound {AGREE_RTOL}); against the nearest other pair's {other!r}"
        )
        if not own <= AGREE_RTOL:
            fails.append(f"({r['a']}, {r['b']}): window {own!r}")
    csv_mean = statistics.mean(v[1] for v in csv.values())
    d_mean = abs(statistics.mean(nits) - csv_mean) / csv_mean
    log(
        f"phase 14b [{card}]: examples.cameraman_deblur (15 pairs, {len(sweep['nit'])} lanes): "
        f"{sweep['wall']:.3f} s inside the pool; wrote {sweep['written']}; mean nit "
        f"{statistics.mean(nits)!r} against the CSV's {csv_mean!r} ({d_mean:.4f}, bound "
        f"{WL_MEAN_RTOL}); largest pair deviation "
        f"{max(abs(a - csv[(r['a'], r['b'])][1]) / csv[(r['a'], r['b'])][1] for a, r in zip(nits, sweep['rows']))!r}"
        f" (bound {WL_NIT_RTOL})"
    )
    if fails or not d_mean <= WL_MEAN_RTOL or "cameraman_ab.csv" not in sweep["written"]:
        raise AssertionError(f"phase 14b: the sweep does not hold: {fails}, mean {d_mean!r}")


def phase14cd(card14: dict, results: dict, models) -> None:
    """(c) and (d) after the pool, for ``models``: the card's windows and
    F against the CPU's."""
    for name, key in (("logistic", "logistic"), ("group_lasso", "group")):
        if name not in models:
            continue
        lr = card14["logistic_lr"] if name == "logistic" else None
        for run, c in results[("windows", name, lr)].items():
            f64 = card14[f"{key}_f64"][run]
            rel = float(np.linalg.norm(f64["x"] - c["x"]) / np.linalg.norm(c["x"]))
            log(
                f"phase 14{'c' if name == 'logistic' else 'd'}: {name} {run}, {MODEL_WINDOW} "
                f"iterations, float64 card vs CPU: nit {f64['nit']} vs {c['nit']}, trials "
                f"{f64['nit_internal']} vs {c['nit_internal']}, x relative {rel!r} (bound 1e-9)"
            )
            if (f64["nit"], f64["nit_internal"]) != (c["nit"], c["nit_internal"]) or not rel <= 1e-9:
                raise AssertionError(f"phase 14: {name} {run} float64 card and CPU differ")
            f32 = card14.get(f"{key}_f32", {}).get(run)
            if f32 is not None:
                rel = float(np.linalg.norm(f32["x"] - c["x"]) / np.linalg.norm(c["x"]))
                log(
                    f"phase 14c: {name} {run}, {MODEL_WINDOW} iterations, float32 card vs float64 "
                    f"CPU: x relative {rel!r} (bound {AGREE_RTOL}); trials {f32['nit_internal']} "
                    f"vs {c['nit_internal']}"
                )
                if not rel <= AGREE_RTOL:
                    raise AssertionError(f"phase 14c: {name} {run} float32 disagrees with float64")
        ref = results[("model_cpu", name)]
        for run, fun in card14[f"{key}_funs"].items():
            d_fun = _rel(fun, ref["fun"])
            log(
                f"phase 14{'c' if name == 'logistic' else 'd'}: {name} {run} solve, float32 card "
                f"F {fun!r} against the float64 CPU default solve's {ref['fun']!r} (nit "
                f"{ref['nit']}, {ref['wall']:.1f} s in the pool): relative {d_fun:.3e} "
                f"(bound {MODEL_FRTOL})"
            )
            if ref["status"] != 1 or not d_fun <= MODEL_FRTOL:
                raise AssertionError(f"phase 14: {name} {run} F disagrees with the float64 solve")


# -- phase 15: scale-out ---------------------------------------------------------

#: Phase 15b-c: the lambda sweep's lanes (over the headline LASSO's A).
SWEEP15_LANES = 16
#: Phase 15a: the relative bound on the float32 objective after the large
#: LASSO's steps against the same steps in float64 (float32 rounding over
#: 200 momentum steps).
LARGE_FRTOL = 1e-4
#: Phase 15c: the m=1 class, in float64 (equal nit, x within 1e-9).
GLOO_XTOL = 1e-9


def copy_gbps(dev, n_bytes: int = 2**31, reps: int = 10) -> float:
    """The card's device-to-device ``copy_`` rate (bytes read plus bytes
    written per second), by CUDA events over ``reps`` copies of
    ``n_bytes``, after one untimed copy."""
    src = torch.empty(n_bytes // 4, dtype=torch.float32, device=dev).uniform_()
    dst = torch.empty_like(src)
    dst.copy_(src)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    torch.cuda.synchronize()
    return 2 * n_bytes * reps / (start.elapsed_time(end) * 1e-3) / 1e9


def phase15a(card: str, dev) -> dict:
    """The n = 10^6 LASSO at full width (``large_lasso``'s main path, A 8 GB
    float32): its script's run in this process (launch counts), then the
    same 200 steps fused against plain (bitwise) and in float64 (the
    objective within LARGE_FRTOL)."""
    from zfista_tpu_torch.examples import large_lasso
    from zfista_tpu_torch.models.lasso import fista_step_dense, operator_norm_sq
    from zfista_tpu_torch.ops import fused

    argv = ["--n", str(LARGE_N), "--m", str(LARGE_M), "--iters", str(LARGE_ITERS)]
    out = io.StringIO()
    zero(fused.launch_counts)  # the main-path run starts here
    with contextlib.redirect_stdout(out):
        large_lasso.main(argv)
    torch.cuda.synchronize()
    launched = dict(fused.launch_counts)  # ... and ends here
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    if launched != {"fused_prox_momentum": 0, "fista_tail": 2 * LARGE_ITERS, "lasso_step_tail": 0,
                    "lasso_normal_gemv": 0}:
        raise AssertionError(f"phase 15a: large_lasso launched {launched}")
    gbps = copy_gbps(dev)
    bound_ms = 1e3 * 2 * LARGE_M * LARGE_N * 4 / PEAK_BYTES_PER_S
    log(
        f"phase 15a [{card}]: large_lasso m={LARGE_M} n={LARGE_N} f32 (A {LARGE_M * LARGE_N * 4 / 1e9:.0f} GB): "
        f"{rec['value']!r} iter/s, {rec['achieved_GBps']!r} GB/s over {LARGE_ITERS} steps "
        f"(copy_ {gbps!r} GB/s in this run; bound {bound_ms:.3f} ms = {1e3 / bound_ms:.1f} iter/s "
        f"at 3.35 TB/s); warm-up {rec['warmup_s']!r} s; final_obj {rec['final_obj']!r}; "
        f"fista_tail launches {launched['fista_tail']} in {2 * LARGE_ITERS} steps (warm-up and timed); "
        f"the script's device {rec['device']!r}"
    )

    A, b = large_lasso.build_operator(LARGE_M, LARGE_N, 0, None, dev)
    lr = (1.0 / (2 * operator_norm_sq(A, 30))).to(torch.float32)
    lam = torch.tensor(0.01, dtype=torch.float32, device=dev)
    x0 = torch.zeros(LARGE_N, dtype=torch.float32, device=dev)
    got = large_lasso.iterate(A, b, lam, lr, x0, LARGE_ITERS)
    c = (x0, x0, torch.ones((), dtype=torch.float32, device=dev))
    for _ in range(LARGE_ITERS):
        c = fista_step_dense(A, b, lam, lr, c)
    err = max(abs_err(u, v) for u, v in zip(got, c))
    if err != 0.0 or not all(same_bits(u, v) for u, v in zip(got, c)):
        raise AssertionError(f"phase 15a: fused steps differ from plain by {err!r}")
    F32 = large_lasso.objective(A, b, lam, got[0])
    if F32 != rec["final_obj"]:
        raise AssertionError(f"phase 15a: the script's final_obj {rec['final_obj']!r} is not {F32!r}")
    A64, b64 = A.double(), b.double()
    del A, c
    x64 = torch.zeros(LARGE_N, dtype=torch.float64, device=dev)
    c = (x64, x64, torch.ones((), dtype=torch.float64, device=dev))
    lr64, lam64 = lr.double(), lam.double()
    for _ in range(LARGE_ITERS):
        c = fista_step_dense(A64, b64, lam64, lr64, c)
    F64 = large_lasso.objective(A64, b64, lam64, c[0])
    rel = abs(F32 - F64) / abs(F64)
    log(
        f"phase 15a: {LARGE_ITERS} fused steps == plain bitwise (x, y, t); F float32 {F32!r} "
        f"against float64 {F64!r} on the card (A cast, 16 GB): relative {rel!r} "
        f"(bound {LARGE_FRTOL})"
    )
    if not rel <= LARGE_FRTOL:
        raise AssertionError("phase 15a: float32 objective off float64's")
    del A64, c
    torch.cuda.empty_cache()
    return dict(launches=launched["fista_tail"], iter_s=rec["value"], gbps=rec["achieved_GBps"],
                copy_gbps=gbps, step_err=err)


def sweep15(A, b, lams, lr: float, in_sharding=None):
    """Phase 15's lambda sweep over the headline LASSO's A, to convergence."""
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    f, g, jac_f, prox = make_lasso_lambda_sweep(A, b)
    return quiet(
        minimize_proximal_gradient_batch, f, g, jac_f, prox,
        torch.zeros((len(lams), A.shape[1]), dtype=A.dtype, device=A.device),
        batch_params=lams, in_sharding=in_sharding, lr=lr, nesterov=True, max_iter=5000,
    )


def same_batch(u, v) -> bool:
    return all(np.array_equal(np.asarray(u[k]), np.asarray(v[k])) for k in ("x", "nit", "status")) and all(
        np.array_equal(a, c) for a, c in zip(u.state, v.state)
    )


def phase15b(card: str, dev, A_np, b_np, lr: float) -> dict:
    """A world of one NCCL rank on the card: the headline LASSO through
    ``Lasso`` on ``distribute_global(A, mesh, operator_sharding)`` to
    convergence, bitwise the unsharded solve through the same two
    gradient products (``two_products``: the whole operator's own solve
    takes the single-pass kernel, its result logged beside), through the
    composed tail; the lambda sweep with ``in_sharding`` bitwise the
    unsharded sweep."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.ops import fused
    from zfista_tpu_torch.parallel import batch_sharding, distributed
    from zfista_tpu_torch.parallel.sharding import P

    distributed.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = distributed.global_mesh()
        b = torch.as_tensor(b_np, device=dev)
        sharded = Lasso(distributed.distribute_global(A_np, mesh, P(None, "model"), dev), b, LAM)
        x0 = distributed.distribute_global(np.zeros(N, np.float32), mesh, P("model"), dev)
        zero(fused.launch_counts)  # the main-path solve starts here
        res_sh = sharded.solve_fixed_step(x0, lr=lr)
        torch.cuda.synchronize()
        launched = dict(fused.launch_counts)  # ... and ends here
        x_whole = torch.zeros(N, dtype=torch.float32, device=dev)
        with two_products():
            res = Lasso(torch.as_tensor(A_np, device=dev), b, LAM).solve_fixed_step(x_whole, lr=lr)
        one = Lasso(torch.as_tensor(A_np, device=dev), b, LAM).solve_fixed_step(x_whole, lr=lr)
        log(
            f"phase 15b [{card}]: the unsharded solve by the single-pass gradient: nit={one.nit} "
            f"status={one.status}; x relative 2-norm diff from the two products' "
            f"{float(np.linalg.norm(one.x - res.x) / np.linalg.norm(res.x))!r}"
        )
        if one.status != 1:
            raise AssertionError("phase 15b: the single-pass solve did not converge")
        chunk = chunk_of(None, dev)
        steps = chunk * math.ceil(res_sh.nit / chunk)  # the solver runs whole chunks
        log(
            f"phase 15b [{card}]: NCCL world of 1: feature-sharded Lasso.solve_fixed_step "
            f"nit={res_sh.nit} status={res_sh.status} (unsharded {res.nit}, {res.status}); x "
            f"bitwise equal: {np.array_equal(res_sh.x, res.x)}; kernel launches {launched} in "
            f"{steps} steps run"
        )
        if res_sh.status != 1 or res_sh.nit != res.nit or not np.array_equal(res_sh.x, res.x):
            raise AssertionError("phase 15b: the sharded solve differs from the unsharded one")
        if launched != {"fused_prox_momentum": steps, "fista_tail": 0, "lasso_step_tail": 0,
                        "lasso_normal_gemv": 0}:
            raise AssertionError(f"phase 15b: launches {launched}, expected {steps} of fused_prox_momentum")
        A_t = torch.as_tensor(A_np, device=dev)
        lams = torch.linspace(0.005, 0.05, SWEEP15_LANES, dtype=torch.float32, device=dev)
        sw_sh = sweep15(A_t, b, lams, lr, batch_sharding(mesh))
        sw = sweep15(A_t, b, lams, lr)
        log(
            f"phase 15b: lambda sweep of {SWEEP15_LANES} lanes with in_sharding: nit "
            f"{sw_sh.nit.tolist()}; bitwise the unsharded sweep: {same_batch(sw_sh, sw)}"
        )
        if not (sw_sh.success.all() and same_batch(sw_sh, sw)):
            raise AssertionError("phase 15b: the sharded sweep differs from the unsharded one")
    finally:
        distributed.shutdown()
    return dict(launches=launched["fused_prox_momentum"])


def phase15c_rank(rank: int, port: int, lr: float, device: str, out) -> None:
    """One of phase 15c's Gloo ranks on ``device`` (card 0): the headline
    LASSO in float64 with its features over ``model=2``, and the lambda
    sweep with its lanes over ``batch=2``; puts (rank, results) on
    ``out``."""
    warnings.simplefilter("ignore")
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.ops import fused
    from zfista_tpu_torch.parallel import batch_sharding, distributed
    from zfista_tpu_torch.parallel.sharding import P

    dev = torch.device(device)
    distributed.initialize(
        f"localhost:{port}", GLOO_RANKS, rank,
        local_device_ids=None if dev.index is None else [dev.index], backend="gloo",
    )
    try:
        A_np, b_np = (v.astype(np.float64) for v in make_problem())
        mesh = distributed.global_mesh(batch=1, model=GLOO_RANKS)
        prob = Lasso(distributed.distribute_global(A_np, mesh, P(None, "model"), dev),
                     torch.as_tensor(b_np, device=dev), LAM)
        x0 = distributed.distribute_global(np.zeros(N), mesh, P("model"), dev)
        zero(fused.launch_counts)  # the main-path solve starts here
        res = prob.solve_fixed_step(x0, lr=lr)
        torch.cuda.synchronize()
        launched = dict(fused.launch_counts)  # ... and ends here
        mesh_b = distributed.global_mesh(batch=GLOO_RANKS, model=1)
        lams = torch.linspace(0.005, 0.05, SWEEP15_LANES, dtype=torch.float64, device=dev)
        sw = sweep15(torch.as_tensor(A_np, device=dev), torch.as_tensor(b_np, device=dev), lams,
                     lr, batch_sharding(mesh_b))
        out.put((rank, dict(x=res.x, nit=res.nit, status=res.status, launched=launched,
                            block=int(prob.A.shape[1]),
                            sweep=dict(x=sw.x, nit=sw.nit, status=sw.status, state=tuple(sw.state)))))
    finally:
        distributed.shutdown()


def phase15c(card: str, dev) -> dict:
    """Two processes sharing the card over Gloo (NCCL refuses two ranks on
    one device; Gloo takes CUDA tensors in all-reduce), in float64: the
    feature-sharded headline LASSO in the m=1 class of the unsharded card
    solve, and the lane-sharded sweep bitwise the unsharded sweep."""
    from zfista_tpu_torch.models import Lasso

    A_np, b_np = (v.astype(np.float64) for v in make_problem())
    b = torch.as_tensor(b_np, device=dev)
    A = torch.as_tensor(A_np, device=dev)
    lr = 1.0 / Lasso(A, b, LAM).lipschitz()
    ranks = run_ranks("phase 15c", phase15c_rank, GLOO_RANKS, (lr, str(dev)))
    ref = Lasso(A, b, LAM).solve_fixed_step(torch.zeros(N, dtype=torch.float64, device=dev), lr=lr)
    lams = torch.linspace(0.005, 0.05, SWEEP15_LANES, dtype=torch.float64, device=dev)
    sw = sweep15(A, b, lams, lr)
    chunk = chunk_of(None, dev)
    for r, got in sorted(ranks.items()):
        dx = float(np.max(np.abs(got["x"] - ref.x)))
        sw_got = got["sweep"]
        differ = [k for k in ("x", "nit", "status") if not np.array_equal(sw_got[k], sw[k])] + [
            name for name, a, c in zip(sw.state._fields, sw_got["state"], sw.state)
            if not np.array_equal(a, c)
        ]
        steps = chunk * math.ceil(got["nit"] / chunk)  # the solver runs whole chunks
        log(
            f"phase 15c [{card}]: Gloo rank {r}/{GLOO_RANKS} on {dev}, float64: feature-sharded "
            f"(block of {got['block']}) nit={got['nit']} status={got['status']} (unsharded {ref.nit}), "
            f"max|x - x_unsharded| {dx!r} (bound {GLOO_XTOL}); kernel launches {got['launched']} in "
            f"{steps} steps run; lane-sharded sweep nit {got['sweep']['nit'].tolist()}; fields not "
            f"bitwise the unsharded sweep's: {differ}"
        )
        if got["status"] != 1 or got["nit"] != ref.nit or not dx <= GLOO_XTOL:
            raise AssertionError(f"phase 15c: rank {r}'s sharded solve is outside the m=1 class")
        if got["launched"] != {"fused_prox_momentum": steps, "fista_tail": 0, "lasso_step_tail": 0,
                               "lasso_normal_gemv": 0}:
            raise AssertionError(f"phase 15c: rank {r} launched {got['launched']}, expected {steps} "
                                 "of fused_prox_momentum")
        if differ:
            raise AssertionError(f"phase 15c: rank {r}'s sharded sweep differs from the unsharded one")
    return dict(launches=sum(g["launched"]["fused_prox_momentum"] for g in ranks.values()),
                block=ranks[0]["block"])


def phase15d(card: str) -> dict:
    """``bench.scaling.weak_scaling((1,), device="cuda")`` at its defaults:
    the 1-device row (one NCCL process)."""
    from zfista_tpu_torch.bench import scaling

    rows = scaling.weak_scaling((1,), device="cuda")
    log(f"phase 15d [{card}]: weak_scaling((1,), device='cuda'):\n{scaling.format_table(rows)}\n{rows!r}")
    if len(rows) != 1 or rows[0]["devices"] != 1 or not rows[0]["lane_iters_per_s"] > 0:
        raise AssertionError(f"phase 15d: rows {rows}")
    return rows[0]


#: Phase 15e: feature-sharded solves with two and three objectives, float64.
#: JOS1 at large_lasso's width, l1 ratios 0.1/n (f = ||x||^2/n: at ratios
#: of 0.1 the prox at lr = 1/L = n/2 zeroes every feature in the first
#: step), shifts (0, -1), from U(-2, 4): 50 fixed steps at 1/L and 10
#: backtracking iterations (tol 0, Nesterov); FDS at n = 10^5, l1 ratios 0.1,
#: from U(-2, 2): 10 fixed steps at 1/L of its stiffest objective at x0
#: (f1's Hessian diagonal); the 1x2 batch: JOS1 at n = 10^4, 64 lanes, 15
#: fixed steps at 1/L.  (Each window half its earlier length: every check
#: is per step, bitwise or in its class, and holds on fewer steps.)
JOS1_15E_N, FDS_15E_N, BATCH_15E_N, BATCH_15E_LANES = 1_000_000, 100_000, 10_000, 64
JOS1_15E_STEPS, BT_15E_ITERS, FDS_15E_STEPS, BATCH_15E_STEPS = 50, 10, 10, 15
#: The classes against the unsharded card solve: equal nit, x within these
#: (m = 2, m = 3); seconds a Gloo collective waits for the other rank.
X15E_TOL, GLOO_15E_TIMEOUT = {2: 1e-8, 3: 1e-6}, 300


def jos1_15e(n: int, sharding=None):
    """Phase 15e's JOS1 at ``n`` features and its fixed step 1/L."""
    from zfista_tpu_torch.models import JOS1

    # Both objectives' Hessians are 2/n I.
    return JOS1(n, l1_ratios=[0.1 / n] * 2, l1_shifts=[0.0, -1.0], sharding=sharding), n / 2


def problems15e(sharding=None) -> dict:
    """Phase 15e's single solves: name -> (problem, x0 as numpy, the solve's
    keywords), on ``sharding``'s feature blocks when given."""
    from zfista_tpu_torch.models import FDS

    jos1, lr_j = jos1_15e(JOS1_15E_N, sharding)
    x_j = np.random.default_rng(15).uniform(-2.0, 4.0, JOS1_15E_N)
    n = FDS_15E_N
    x_f = np.random.default_rng(16).uniform(-2.0, 2.0, n)
    k = np.arange(1, n + 1)
    lr_f = 1.0 / float(np.max(12 * k * (x_f - k) ** 2) / n**2)
    return {
        "jos1_fixed": (jos1, x_j, dict(decay_rate=1, lr=lr_j, nesterov=True, tol=0.0,
                                       max_iter=JOS1_15E_STEPS)),
        "jos1_backtracking": (jos1, x_j, dict(nesterov=True, tol=0.0, max_iter=BT_15E_ITERS)),
        "fds_fixed": (FDS(n, l1_ratios=[0.1] * 3, sharding=sharding), x_f,
                      dict(decay_rate=1, lr=lr_f, tol=0.0, check_every=1, max_iter=FDS_15E_STEPS)),
    }


def batch15e(sharding=None) -> tuple:
    """Phase 15e (c)'s batch: (problem, x0s as numpy, the solve's keywords)."""
    jos1, lr = jos1_15e(BATCH_15E_N, sharding)
    x0s = np.random.default_rng(17).uniform(-2.0, 4.0, (BATCH_15E_LANES, BATCH_15E_N))
    return jos1, x0s, dict(decay_rate=1, lr=lr, nesterov=True, tol=0.0, max_iter=BATCH_15E_STEPS)


def timed_solve(run) -> tuple:
    """``run()`` with its wall (synchronised), the all-reduces it issued and
    the fused kernel's launches."""
    from zfista_tpu_torch.ops import fused
    from zfista_tpu_torch.parallel import sharding as shd

    torch.cuda.synchronize()
    before, launched = dict(shd.collective_counts), dict(fused.launch_counts)
    t0 = time.perf_counter()
    res = quiet(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: shd.collective_counts[k] - before[k] for k in before}
    return res, wall, counts, {k: fused.launch_counts[k] - launched[k] for k in launched}


def phase15e_rank(rank: int, port: int, device: str, world: int, out) -> None:
    """One of phase 15e's ranks on ``device`` (card 0): with ``world`` 1 an
    NCCL world of one rank, (a)'s fixed-step solves from a 1x1 mesh's
    blocks; else a Gloo rank, every single solve on the features' blocks
    (a 1 x ``world`` mesh) and (c)'s batch on it.  Puts (rank, results)
    on ``out``."""
    warnings.simplefilter("ignore")
    from zfista_tpu_torch.parallel import distributed
    from zfista_tpu_torch.parallel import sharding as shd

    dev = torch.device(device)
    nccl = world == 1
    distributed.initialize(
        f"localhost:{port}", world, rank, local_device_ids=None if dev.index is None else [dev.index],
        backend="nccl" if nccl else "gloo", timeout=GLOO_15E_TIMEOUT,
    )
    try:
        fs = shd.feature_sharding(distributed.global_mesh(batch=1, model=world))
        cases = problems15e(fs)
        if nccl:
            del cases["jos1_backtracking"]  # (b) takes it
        else:
            cases["batch"] = batch15e(fs)
        got: dict = {}
        for name, (prob, x0, kw) in cases.items():
            solve = prob.solve_batch if name == "batch" else prob.solve
            res, wall, counts, launched = timed_solve(lambda: solve(x0, device=dev, **kw))
            got[name] = dict(x=res.x, nit=np.asarray(res.nit), status=np.asarray(res.status), wall=wall,
                             counts=counts, launched=launched, block=prob.block_size,
                             state=tuple(np.asarray(v) for v in res.state),
                             nit_internal=np.asarray(res.nit_internal),
                             same=distributed.all_processes_allclose(res.x, atol=0, rtol=0))
        out.put((rank, got))
    finally:
        distributed.shutdown()


def phase15e(card: str, dev) -> dict:
    """Feature-sharded solves with two and three objectives on the card,
    float64: (a) an NCCL world of one rank, JOS1 (m = 2) and FDS (m = 3)
    from a ``feature_sharding`` block bitwise the unsharded card solve in
    every State field; (b) two Gloo ranks sharing the card, JOS1 by the
    fixed step and by backtracking in the m = 2 class of the unsharded
    card solve and FDS in the m = 3 class, both ranks' x bitwise equal; (c)
    a 1x2 batch of JOS1 on the two ranks, each lane in the m = 2 class of
    the unsharded card batch.  Walls and all-reduces per outer iteration
    beside; no phase-15e run launches the fused kernel.  The three ranks
    run in spawned processes, at once, while this process computes the
    unsharded references."""
    one = start_ranks(phase15e_rank, 1, (str(dev), 1))
    pair = start_ranks(phase15e_rank, GLOO_RANKS, (str(dev), GLOO_RANKS))
    try:
        refs = {}
        for name, (prob, x0, kw) in problems15e().items():
            refs[name] = timed_solve(lambda: prob.solve(torch.as_tensor(x0, device=dev), **kw))
        prob, x0s, kw = batch15e()
        refs["batch"] = timed_solve(lambda: prob.solve_batch(torch.as_tensor(x0s, device=dev), **kw))
        worlds = {1: collect_ranks("phase 15e (a)", *one), GLOO_RANKS: collect_ranks("phase 15e", *pair)}
    finally:
        for p in one[0] + pair[0]:
            if p.is_alive():
                p.kill()
                p.join()
    cases = dict(problems15e(), batch=batch15e())
    for world, ranks in worlds.items():
        for name, (prob, _, _) in cases.items():
            if name not in ranks[0]:
                continue
            ref, ref_wall, ref_counts, _ = refs[name]
            m = prob.n_objectives
            for r, g in sorted((r, got[name]) for r, got in ranks.items()):
                nit = int(np.max(g["nit"]))
                dx = float(np.max(np.abs(g["x"] - ref.x)))
                differ = [k for k, u, v in zip(ref.state._fields, g["state"], ref.state)
                          if not np.array_equal(u, v)]
                part = "a" if world == 1 else "c" if name == "batch" else "b"
                where = "NCCL world of 1" if world == 1 else f"Gloo rank {r}/{world} on {dev}"
                log(
                    f"phase 15e ({part}) [{card}]: {where}, {name} (n={prob.n_features}, m={m}, block of "
                    f"{g['block']}, float64{f', {BATCH_15E_LANES} lanes on a 1x2 mesh' if name == 'batch' else ''}): "
                    f"nit {g['nit'].tolist()} nit_internal {g['nit_internal'].tolist()} status "
                    f"{g['status'].tolist()} (unsharded {np.asarray(ref.nit).tolist()}, "
                    f"{np.asarray(ref.nit_internal).tolist()}); max|x - x_unsharded| {dx!r} (bound "
                    f"{0.0 if world == 1 else X15E_TOL[m]}); State fields not bitwise the unsharded "
                    f"card solve's: {differ}; x bitwise on every rank: {g['same']}; wall {g['wall']:.3f} s, "
                    f"{1e3 * g['wall'] / nit:.2f} ms an outer iteration (unsharded {ref_wall:.3f} s; "
                    f"the three ranks and this process share the card); all-reduces {g['counts']}, "
                    f"{g['counts']['sum'] / nit:.2f} sums and {g['counts']['max'] / nit:.2f} maxima an "
                    f"outer iteration; fused kernel launches {g['launched']}"
                )
                same_nit = np.array_equal(g["nit"], np.asarray(ref.nit))
                if world == 1 and (differ or not same_nit):
                    raise AssertionError(f"phase 15e (a): {name} on a world of one differs from unsharded")
                if not (same_nit and np.array_equal(g["status"], np.asarray(ref.status))
                        and dx <= X15E_TOL[m] and g["same"]):
                    raise AssertionError(f"phase 15e: rank {r}'s {name} is outside the m = {m} class")
                if any(g["launched"].values()):
                    raise AssertionError(f"phase 15e: rank {r}'s {name} launched the fused kernel")
            if not all(np.array_equal(ranks[0][name]["x"], got[name]["x"]) for got in ranks.values()):
                raise AssertionError(f"phase 15e: the ranks' {name} x differ")
    return {name: worlds[GLOO_RANKS][0][name]["wall"] for name in cases}


#: Phase 16: the two-axis ("batch", "model") mesh of four Gloo ranks on the
#: card, the headline LASSO in float64 (A cast: 80 MB a rank's block).
MESH16, SWEEP16_LANES, WIDE16_LANES, WIDE16_STEPS = (2, 2), 16, 64, 100
#: Phase 16a's sweep and 16c's GroupLasso solves over windows of this many
#: iterations (to the end they take 176-385 and 1,243-1,469), sharded
#: and unsharded alike: their checks are per step, bitwise or within 1e-12.
SWEEP16_ITERS, GROUP16_ITERS = 100, 300
#: 16a and 16c against the unsharded batch and solve: the m=1 class in
#: float64 (equal nit, x within 1e-12); 16b's float32 F against float64's.
X16_TOL, F16_RTOL = 1e-12, 1e-4
#: 16c's group sizes over blocks of N / 2: 10 holds whole groups, 16 has
#: one group straddle the blocks' edge.
GROUPS16 = (10, 16)
#: The sums a fixed-step batch all-reduces beside its steps' own: f of the
#: first lane (the objective count), and F at the start and at the end
#: (f's product and g's sum, each one all-reduce for every lane).
SUMS_OUTSIDE_STEPS = 5


def free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        return s_.getsockname()[1]


def start_ranks(target, world: int, args: tuple) -> tuple:
    """``target(rank, port, *args, out)`` started in ``world`` spawned
    processes (they re-import this module); :func:`collect_ranks` takes
    their results."""
    import multiprocessing as mp

    port = free_port()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, out)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def collect_ranks(label: str, procs: list, out, timeout: float = 600) -> dict:
    """Each rank's result from ``out``, by rank, within ``timeout`` seconds;
    a rank that fails fails the phase.  Stops every process."""
    import queue as queue_mod

    ranks = {}
    deadline = time.monotonic() + timeout
    try:
        while len(ranks) < len(procs):  # drained before the joins
            try:
                r, got = out.get(timeout=5.0)
                ranks[r] = got
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    raise AssertionError(f"{label}: a rank failed: {[p.exitcode for p in procs]}")
        for p in procs:
            p.join(timeout=300)
            if p.exitcode != 0:
                raise AssertionError(f"{label}: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return ranks


def run_ranks(label: str, target, world: int, args: tuple, timeout: float = 600) -> dict:
    """``target(rank, port, *args, out)`` in ``world`` spawned processes
    (they re-import this module); returns each rank's result from ``out``,
    by rank.  A rank that fails fails the phase."""
    return collect_ranks(label, *start_ranks(target, world, args), timeout=timeout)


def batch_fields(r) -> dict:
    """A batch result's per-lane fields and state, as numpy."""
    out = {k: np.asarray(r[k]) for k in ("x", "nit", "nit_internal", "fun", "lr", "error_criterion", "status")}
    if r.state is not None:
        out.update({f"state.{k}": np.asarray(v) for k, v in r.state._asdict().items()})
    return out


def lams16(lanes: int) -> np.ndarray:
    return np.geomspace(0.005, 0.05, lanes)


def phase16_rank(rank: int, port: int, device: str, lr64: float, lr32: float, out) -> None:
    """One of phase 16's four Gloo ranks on ``device`` (card 0): (a) the
    float64 lambda sweep on the 2x2 mesh and on the 1x2 mesh of the rank's
    batch row; (b) the float32 fixed-step sweep on the 2x2 mesh, with its
    all-reduces counted; (c) ``GroupLasso`` on the two feature blocks of
    the rank's batch row, one group size a row.  Puts (rank, results) on
    ``out``."""
    warnings.simplefilter("ignore")
    from zfista_tpu_torch.models import GroupLasso
    from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import distributed, minimize_proximal_gradient_batch
    from zfista_tpu_torch.parallel import sharding as shd
    from zfista_tpu_torch.parallel.sharding import P

    dev = torch.device(device)
    world = MESH16[0] * MESH16[1]
    distributed.initialize(f"localhost:{port}", world, rank,
                           local_device_ids=None if dev.index is None else [dev.index], backend="gloo")
    try:
        A32, b32 = make_problem()
        A64, b64 = A32.astype(np.float64), b32.astype(np.float64)
        mesh = distributed.global_mesh(*MESH16)
        # Every rank makes every mesh, in one order (new_group).
        rows = [shd.make_mesh(1, MESH16[1], devices=list(r)) for r in mesh.devices.tolist()]
        got: dict = {}
        for name, m_ in (("2x2", mesh), ("1x2", rows[mesh.index("batch")])):
            fns = make_lasso_lambda_sweep(distributed.distribute_global(A64, m_, P(None, "model"), dev),
                                          torch.as_tensor(b64, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = minimize_proximal_gradient_batch(
                *fns, np.zeros((SWEEP16_LANES, N)), batch_params=torch.as_tensor(lams16(SWEEP16_LANES), device=dev),
                lr=lr64, nesterov=True, max_iter=SWEEP16_ITERS)
            torch.cuda.synchronize()
            got[f"a_{name}"] = dict(batch_fields(r), wall=time.perf_counter() - t0)
        fns = make_lasso_lambda_sweep(distributed.distribute_global(A32, mesh, P(None, "model"), dev),
                                      torch.as_tensor(b32, device=dev))
        kw = dict(batch_params=torch.as_tensor(lams16(WIDE16_LANES), dtype=torch.float32, device=dev),
                  lr=lr32, decay_rate=1, nesterov=True, tol=0, keep_state=False)
        x0s = np.zeros((WIDE16_LANES, N), np.float32)
        minimize_proximal_gradient_batch(*fns, x0s, max_iter=2, **kw)  # first-use costs
        torch.cuda.synchronize()
        before = dict(shd.collective_counts)
        t0 = time.perf_counter()
        r = minimize_proximal_gradient_batch(*fns, x0s, max_iter=WIDE16_STEPS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got["b"] = dict(fun=np.asarray(r.fun), nit=np.asarray(r.nit), wall=wall,
                        counts={k: shd.collective_counts[k] - before[k] for k in before})
        # (c) each row of the mesh, two ranks, one group size.
        row, gs = rows[mesh.index("batch")], GROUPS16[mesh.index("batch")]
        x = torch.as_tensor(np.random.default_rng(16).standard_normal(N), device=dev)
        prob = GroupLasso(distributed.distribute_global(A64, row, P(None, "model"), dev),
                          torch.as_tensor(b64, device=dev), LAM, gs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prob.solve(np.zeros(N), nesterov=True, tol=GROUP_TOL, max_iter=GROUP16_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        whole = GroupLasso(torch.as_tensor(A64, device=dev), torch.as_tensor(b64, device=dev),
                           LAM, gs).prox_wsum_g(0.5, x)
        fsh = shd.feature_sharding(row)
        prox = prob.prox_wsum_g(0.5, shd.block(x, fsh))
        got["c"] = dict(gs=gs, x=res.x, nit=res.nit, nit_internal=res.nit_internal, status=res.status,
                        wall=wall, prox_bitwise=same_bits(prox, shd.block(whole, fsh)),
                        prox_err=abs_err(prox, shd.block(whole, fsh)))
        out.put((rank, got))
    finally:
        distributed.shutdown()


def phase16(card: str, dev) -> dict:
    """The two-axis mesh on the card: (a) the headline LASSO's 16-lane
    float64 lambda sweep (backtracking from 1/L) on 2 (batch) x 2 (model)
    Gloo ranks, every field of every lane bitwise the 1x2 (model-only)
    batch of the same lanes and, against the unsharded batch, equal nit and
    x within X16_TOL; (b) 64 float32 lanes, 100 fixed steps at 1/L on the
    same mesh: lane-iterations/s, one all-reduce per product and one max
    per step for all lanes, F per lane within F16_RTOL of the float64
    batch; (c) ``GroupLasso`` on two feature blocks with groups that align
    and that straddle: equal nit and x within X16_TOL of unsharded, the
    aligned prox bitwise; and the group sweep's lanes bitwise among 16 or
    8; (d) the parity worker on four ranks of the card, while this process
    computes (a)-(c)'s unsharded references."""
    from zfista_tpu_torch.models import Lasso

    A32, b32 = make_problem()
    A64, b64 = (torch.as_tensor(v.astype(np.float64), device=dev) for v in (A32, b32))
    lr64 = 1.0 / Lasso(A64, b64, LAM).lipschitz()
    lr32 = 1.0 / Lasso(torch.as_tensor(A32, device=dev), torch.as_tensor(b32, device=dev), LAM).lipschitz()
    world = MESH16[0] * MESH16[1]
    t0 = time.perf_counter()
    ranks = run_ranks("phase 16", phase16_rank, world, (str(dev), lr64, lr32))
    wall_ranks = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "zfista_tpu_torch.parallel.distributed", "--coordinator",
             f"localhost:{port}", "--num-processes", str(world), "--process-id", str(i),
             "--platform", "cuda", "--backend", "gloo"],
            env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(world)
    ]
    try:
        rates = checks16(card, dev, ranks, A64, b64, lr64, lr32)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_d = time.perf_counter() - t0
    for i, (p, text) in enumerate(zip(procs, outs)):
        oks = [ln for ln in text.splitlines() if "_OK " in ln]
        log(f"phase 16d [{card}]: parity worker rank {i}/{world} on cuda:0 (rc {p.returncode}): {oks}")
        for tag in ("PARITY_OK", "TP_PARITY_OK", "MESH2D_PARITY_OK"):
            if p.returncode != 0 or not any(ln.startswith(f"{tag} process={i}/{world}") for ln in oks):
                raise AssertionError(f"phase 16d: rank {i} printed no {tag}:\n{text[-3000:]}")
    log(f"phase 16 [{card}]: ranks of 16a-c {wall_ranks:.1f} s; the parity worker, beside the "
        f"references, {wall_d:.1f} s")
    return dict(lane_iters_per_s=rates, wall_ranks=wall_ranks, wall_parity=wall_d)


def checks16(card: str, dev, ranks: dict, A64, b64, lr64: float, lr32: float) -> list[float]:
    """Phase 16's checks of the ranks' results against unsharded
    references computed here; returns 16b's lane-iterations/s by rank."""
    from zfista_tpu_torch.models import GroupLasso
    from zfista_tpu_torch.models.lasso import make_group_lasso_lambda_sweep, make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    world = len(ranks)
    # (a) 2x2 against 1x2 bitwise, and against the unsharded batch.
    ref = batch_fields(minimize_proximal_gradient_batch(
        *make_lasso_lambda_sweep(A64, b64), torch.zeros((SWEEP16_LANES, N), dtype=torch.float64, device=dev),
        batch_params=torch.as_tensor(lams16(SWEEP16_LANES), device=dev), lr=lr64, nesterov=True,
        max_iter=SWEEP16_ITERS))
    for r, got in sorted(ranks.items()):
        two, one = got["a_2x2"], got["a_1x2"]
        differ = [k for k in ref if not np.array_equal(two[k], one[k])]
        dx = float(np.max(np.abs(two["x"] - ref["x"])))
        log(
            f"phase 16a [{card}]: Gloo rank {r}/{world} on {dev}, 2x2 mesh, float64 sweep of "
            f"{SWEEP16_LANES} lanes (blocks {M}x{N // MESH16[1]}, {SWEEP16_LANES // MESH16[0]} lanes a rank): "
            f"nit {two['nit'].tolist()} (unsharded {ref['nit'].tolist()}); max|x - x_unsharded| {dx!r} "
            f"(bound {X16_TOL}); fields not bitwise the 1x2 batch's: {differ}; walls 2x2 {two['wall']:.3f} s, "
            f"1x2 {one['wall']:.3f} s"
        )
        if differ:
            raise AssertionError(f"phase 16a: rank {r}'s 2x2 batch differs from the 1x2 batch in {differ}")
        if not (np.array_equal(two["status"], ref["status"]) and np.array_equal(two["nit"], ref["nit"])
                and dx <= X16_TOL):
            raise AssertionError(f"phase 16a: rank {r}'s sweep is outside the m=1 class of the unsharded one")

    # (b) float32 against float64, all-reduces per step, lane-iterations/s.
    ref64 = minimize_proximal_gradient_batch(
        *make_lasso_lambda_sweep(A64, b64), torch.zeros((WIDE16_LANES, N), dtype=torch.float64, device=dev),
        batch_params=torch.as_tensor(lams16(WIDE16_LANES), device=dev), lr=lr32, decay_rate=1,
        nesterov=True, tol=0, max_iter=WIDE16_STEPS, keep_state=False)
    want = {"sum": WIDE16_STEPS + SUMS_OUTSIDE_STEPS, "max": WIDE16_STEPS}
    rates = []
    for r, got in sorted(ranks.items()):
        b = got["b"]
        rel = float(np.max(np.abs(b["fun"] - ref64.fun) / np.abs(ref64.fun)))
        rates.append(WIDE16_LANES * WIDE16_STEPS / b["wall"])
        log(
            f"phase 16b [{card}]: Gloo rank {r}/{world}, 2x2 mesh, {WIDE16_LANES} float32 lanes x "
            f"{WIDE16_STEPS} fixed steps: wall {b['wall']:.3f} s, {rates[-1]:.1f} lane-iterations/s; "
            f"all-reduces {b['counts']} = {(b['counts']['sum'] - SUMS_OUTSIDE_STEPS) / WIDE16_STEPS!r} "
            f"per step for the products and {b['counts']['max'] / WIDE16_STEPS!r} for the maxima, "
            f"for all {WIDE16_LANES // MESH16[0]} lanes of the rank; F against float64: largest "
            f"relative {rel!r} (bound {F16_RTOL})"
        )
        if {k: b["counts"][k] for k in want} != want or not np.all(b["nit"] == WIDE16_STEPS):
            raise AssertionError(f"phase 16b: rank {r} issued {b['counts']}, expected {want}")
        if not rel <= F16_RTOL:
            raise AssertionError(f"phase 16b: rank {r}'s float32 F is off float64's")

    # (c) GroupLasso on two blocks against unsharded; the group sweep's lanes.
    for gs in GROUPS16:
        one = GroupLasso(A64, b64, LAM, gs).solve(np.zeros(N), nesterov=True, tol=GROUP_TOL,
                                                  max_iter=GROUP16_ITERS)
        for r, got in sorted(ranks.items()):
            c = got["c"]
            if c["gs"] != gs:
                continue
            dx = float(np.max(np.abs(c["x"] - one.x)))
            log(
                f"phase 16c [{card}]: Gloo rank {r}/{world} (a row of 2), GroupLasso(m={M}, n={N} f64, "
                f"group_size {gs}, {'aligned' if (N // 2) % gs == 0 else 'one group straddling the blocks'}"
                f") backtracking: status={c['status']} nit={c['nit']} nit_internal={c['nit_internal']} "
                f"(unsharded {one.nit}, {one.nit_internal}); max|x - x_unsharded| {dx!r} (bound "
                f"{X16_TOL}); prox on the block bitwise the unsharded prox: {c['prox_bitwise']} (max "
                f"err {c['prox_err']!r}); wall {c['wall']:.3f} s"
            )
            if c["status"] != one.status or c["nit"] != one.nit or not dx <= X16_TOL:
                raise AssertionError(f"phase 16c: rank {r}'s group LASSO (groups of {gs}) is off unsharded")
            if (N // 2) % gs == 0 and not c["prox_bitwise"]:
                raise AssertionError(f"phase 16c: rank {r}'s aligned prox is not the unsharded prox")
    fns = make_group_lasso_lambda_sweep(A64, b64, GROUP_SIZE)
    lams = torch.as_tensor(lams16(SWEEP16_LANES), device=dev)
    x0s = torch.zeros((SWEEP16_LANES, N), dtype=torch.float64, device=dev)
    kw = dict(lr=lr64, nesterov=True, max_iter=30)
    many = batch_fields(minimize_proximal_gradient_batch(*fns, x0s, batch_params=lams, **kw))
    few = batch_fields(minimize_proximal_gradient_batch(*fns, x0s[:8], batch_params=lams[:8], **kw))
    differ = [k for k in few if not np.array_equal(many[k][:8], few[k])]
    log(f"phase 16c [{card}]: group sweep (groups of {GROUP_SIZE}, 30 iterations) of {SWEEP16_LANES} "
        f"lanes against its first 8 alone: fields not bitwise: {differ}")
    if differ:
        raise AssertionError(f"phase 16c: the group sweep's lanes depend on the lane count in {differ}")
    return rates


def lasso_setup(dev) -> dict:
    """The LASSO problem of phases 3-5, 9, 13f and 15b on the card: the
    numpy data, the tensors, ``L`` and the fixed step ``lr = 1/L`` as the
    float32 solve stores it (phase 4's ``res.lr``)."""
    from zfista_tpu_torch.models import Lasso

    A_np, b_np = make_problem()
    A = torch.as_tensor(A_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    L = Lasso(A, b, LAM).lipschitz()
    return dict(A_np=A_np, b_np=b_np, A=A, b=b, L=L, lr=float(np.float32(1.0 / L)))


def phase3(dev, lz: dict) -> float:
    """One dense FISTA step, fused against plain, at the full problem size
    (tolerance 0).  Returns the largest difference."""
    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.ops import fused

    A, b = lz["A"], lz["b"]
    lr = torch.tensor(lz["lr"], dtype=torch.float32, device=dev)
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
        f"f32 (L={lz['L']!r}): max_abs_err={step_err!r} (tolerance 0, bitwise)"
    )
    if step_err != 0.0:
        raise AssertionError(f"dense step: fused differs from plain by {step_err!r}")
    return step_err


def same_state(got, ref, what: str) -> None:
    """Raise unless every State field of ``got`` is bitwise ``ref``'s."""
    for name, a, c in zip(got._fields, got, ref):
        if not (a.dtype == c.dtype and np.array_equal(a, c, equal_nan=True)):
            raise AssertionError(f"{what}: differs in State.{name}")


def phase4(card: str, dev, lz: dict) -> dict[str, int]:
    """The LASSO slice through the public entry point: the main-path solve
    (4,000 steps, its chunks replayed CUDA graphs) with its launch count,
    bitwise ``check_every=1`` and 64; the first ``AGREE_ITERS`` against
    float64 numpy; the routed ``tol_rel`` solve; the default-tol solves at
    ``check_every`` auto, 1 and 64, bitwise.  Returns the launches of the
    main-path solves."""
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.ops import fused

    A, b = lz["A"], lz["b"]
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    lasso_launches = {}
    prob = Lasso(A, b, LAM)
    counts = graph_counts()
    replays = graph_replays()
    zero(fused.launch_counts)  # the main-path solve starts here
    t0 = time.perf_counter()
    res = prob.solve_fixed_step(x0, tol=0, max_iter=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(fused.launch_counts)  # ... and ends here
    replays = graph_replays() - replays
    entry = next(reversed(solver._GRAPHS.values()))
    lasso_launches["lasso_step_tail"] = launched["lasso_step_tail"]
    lasso_launches["lasso_normal_gemv"] = launched["lasso_normal_gemv"]
    log(
        f"phase 4 [{card}]: Lasso.solve_fixed_step(tol=0, max_iter=4000): nit={res.nit} "
        f"status={res.status} fun={float(res.fun[0])!r} lr={res.lr!r} kernel launches={launched}; "
        f"chunks: 1 eager then captured ({last_capture_ms(counts):.3f} ms), {replays} graph replays "
        f"of {entry.launches} launches each; wall {wall:.3f} s (with the capture)"
    )
    if res.nit != 4000 or not np.all(np.isfinite(res.x)) or res.x.shape != (N,):
        raise AssertionError("slice run: wrong nit or non-finite x")
    if launched["lasso_step_tail"] < 4000:
        raise AssertionError(f"slice run launched the kernels {launched}")
    if replays != -(-4000 // 64) - 1 or entry.launches["lasso_step_tail"] != 64:
        raise AssertionError(f"slice run: {replays} replays of {entry.launches}")
    lz["lr"] = res.lr
    runs = {}
    for ce in (1, 64):
        t0 = time.perf_counter()
        runs[ce] = prob.solve_fixed_step(x0, lr=res.lr, tol=0, max_iter=4000, check_every=ce)
        torch.cuda.synchronize()
        log(f"phase 4 [{card}]: the same solve at check_every={ce}: wall {time.perf_counter() - t0:.3f} s")
    same_state(res.state, runs[1].state, "graphed solve (check_every auto) against 1")
    same_state(runs[64].state, runs[1].state, "graphed solve (check_every 64) against 1")
    log("phase 4: the graphed 4,000-step solves (check_every auto and 64) are bitwise "
        "check_every=1 in every State field")

    short = Lasso(A, b, LAM).solve_fixed_step(x0, lr=res.lr, tol=0, max_iter=AGREE_ITERS)
    x_np = numpy_fista(lz["A_np"], lz["b_np"], LAM, res.lr, AGREE_ITERS)
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
        replays = graph_replays()
        conv[ce] = Lasso(A, b, LAM).solve_fixed_step(x0, lr=res.lr, check_every=ce)
        log(
            f"phase 4 [{card}]: default-tol solve, check_every={ce}: status={conv[ce].status} "
            f"nit={conv[ce].nit} err={conv[ce].error_criterion!r} "
            f"wall {time.perf_counter() - t0:.3f} s (with the capture); graph replays "
            f"{graph_replays() - replays}"
        )
        if conv[ce].status != 1:
            raise AssertionError(
                f"default-tol solve did not converge (check_every={ce})"
            )
        if (graph_replays() > replays) != (ce != 1):
            raise AssertionError(f"default-tol solve, check_every={ce}: graphed {ce != 1} expected")
    for ce in (None, 64):
        same_state(conv[ce].state, conv[1].state, f"check_every={ce} against 1")
    log(
        "phase 4: check_every=64 and auto (replayed graphs) are bitwise equal to "
        "check_every=1 (x, nit, State)"
    )
    return lasso_launches


def phase4_profile(card: str, dev, lz: dict) -> None:
    """Phase 4's launch counts against the profiler's: a 640-step solve on a
    cached graph (ten replays) counts ``lasso_step_tail`` 640 times, and
    torch.profiler sees as many launches of the step-tail kernel.  Run
    after phase 9 (timings taken after a profiled region come out
    slower)."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.ops import fused

    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    prob = Lasso(lz["A"], lz["b"], LAM)
    kw = dict(lr=lz["lr"], tol=0, max_iter=640)
    quiet(prob.solve_fixed_step, x0, **kw)  # the capture, outside the profile
    replays = graph_replays()
    zero(fused.launch_counts)
    n_events, busy, names = device_events(
        lambda: quiet(prob.solve_fixed_step, x0, **kw), by_name=True, times=True
    )
    counted = fused.launch_counts["lasso_step_tail"]
    seen = sum(c for k, (c, _) in names.items() if "lasso_step_tail_kernel" in k)
    tail_us = sum(t for k, (_, t) in names.items() if "lasso_step_tail_kernel" in k) / max(seen, 1)
    log(
        f"phase 4 [{card}]: a 640-step solve on a cached graph ({graph_replays() - replays} "
        f"replays): lasso_step_tail counted {counted}, torch.profiler's step-tail kernels "
        f"{seen}, {tail_us:.2f} us each inside the graph; {n_events / 640:.2f} device events, "
        f"busy {busy / 640:.1f} us per step"
    )
    if not counted == seen == 640 or graph_replays() - replays != 10:
        raise AssertionError(f"phase 4: launch count {counted} against the profiler's {seen}")


def phase5(card: str, dev, lz: dict) -> tuple[int, dict]:
    """The card's own times of the LASSO slice (iter/s of the public solve
    and the two raw loops, in turns) and of the kernel's three entries at
    every main path's n.  Returns the raw fused loop's ``fista_tail``
    launches and the times."""
    from zfista_tpu_torch.models import Lasso
    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.ops import fused

    A, b = lz["A"], lz["b"]
    lr = torch.tensor(lz["lr"], dtype=torch.float32, device=dev)
    lam = torch.tensor(LAM, dtype=torch.float32, device=dev)
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    iters = 2000

    def public():
        Lasso(A, b, LAM).solve_fixed_step(x0, lr=lz["lr"], tol=0, max_iter=iters)

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
    fista_launches = fused.launch_counts["fista_tail"]
    if fista_launches != iters:
        raise AssertionError(f"the raw fused loop launched {dict(fused.launch_counts)}")
    rates: dict[str, list[float]] = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs)), list(runs)):
        for k in order:
            rates[k].append(iters / sync_time(runs[k]))
    for k, v in rates.items():
        med = statistics.median(v)
        per_iter = BYTES_PER_ITER // 2 if k == "public" else BYTES_PER_ITER
        log(
            f"phase 5 [{card}]: {k}: {med:.1f} iter/s median of {[round(r, 1) for r in v]}; "
            f"{med * per_iter / 1e9:.1f} GB/s against "
            f"{per_iter / 1e6:.0f} MB/iter"
            + (" (a fresh Lasso per run: its capture included)" if k == "public" else "")
        )

    kern_ms: dict[str, dict[tuple, tuple[float, float]]] = {k: {} for k in LASSO_KERNELS}
    for n, dtype in KERNEL_TIME_SIZES:
        y, g, x = (torch.randn(n, device=dev, dtype=dtype) for _ in range(3))
        tail_kw = step_tail_cases(y, g, x, dtype, dev)["active"]
        scal = {
            "fused_prox_momentum": [torch.tensor(v, device=dev, dtype=dtype) for v in (0.1, 0.05, 0.3)],
            "fista_tail": [torch.tensor(v, device=dev, dtype=dtype) for v in (3.7, 0.1, 0.5)],
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
        reps = 500 if n <= N else 100
        width = torch.finfo(dtype).bits // 8
        for name, (kernel, plain) in calls.items():
            k_ms = event_ms(kernel, reps)
            p_ms = event_ms(plain, reps, device_bound=False)
            kern_ms[name][n, dtype] = (k_ms, p_ms)
            log(
                f"phase 5 [{card}]: {name} {str(dtype)[6:]} n={n}: kernel {k_ms * 1e3:.2f} us per "
                f"call back to back ({5 * width * n / (k_ms * 1e-3) / 1e9:.1f} GB/s at "
                f"{5 * width} B/elem), plain {p_ms * 1e3:.2f} us (host-bound)"
            )
    return fista_launches, kern_ms


def gemv_chain(m: int, n: int) -> int:
    """The single-pass gradient's longest chain of float32 roundings into
    one entry: a row's dot product (at most 24 products a thread, 5
    butterfly levels, 16 warps, − b) and a column's sum (its block's rows;
    a slice of at most 17 of the 132 partials; 8 slices).  The doubling is
    exact."""
    from zfista_tpu_torch.ops import fused

    rows = math.ceil(m / min(m, fused.NORMAL_GEMV_BLOCKS))
    return math.ceil(n / 512) + 5 + 16 + 1 + rows + 17 + 8


def phase5b(card: str, dev, lz: dict) -> dict:
    """The single-pass LASSO gradient ``lasso_normal_gemv`` (two launches:
    one pass over A's rows, the partials' sum) on the card.  At every shape
    of ``GEMV_CHECK_SHAPES``, A aligned and 4 bytes past: against the
    float64 gradient within the a-priori bound of its sums, 2·γ_K·|A|ᵀ(|A||y|
    + |b|) with γ_K = K·u/(1 − K·u), u = 2⁻²⁴, K = ``gemv_chain`` + 1 (the
    residual's rounding carried through the second sum); bitwise from one
    launch to the next and against a replayed CUDA graph of it; one launch
    counted a call (the capture's call counts, its replays run no wrapper).
    Then its device time at the main path's shape (phase 4's A and b) by
    ``held_ms``, in turns with the two cuBLAS products and two elementwise
    launches it replaces (``library_ms``), beside its bound: A's bytes once
    at 3.35 TB/s."""
    from zfista_tpu_torch.ops import fused

    rng = np.random.default_rng(3)
    counts = fused.launch_counts
    worst, max_abs = 0.0, 0.0
    for m, n in GEMV_CHECK_SHAPES:
        for offset in (0, 1):
            if (m, n, offset) == (M, N, 0):
                A, b = lz["A"], lz["b"]
            else:
                host = (rng.standard_normal((m, n)) / math.sqrt(m)).astype(np.float32)
                A = torch.empty(m * n + offset, dtype=torch.float32, device=dev)[offset:].view(m, n)
                A.copy_(torch.as_tensor(host))
                b = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device=dev)
            y = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
            before = counts["lasso_normal_gemv"]
            got = fused.lasso_normal_gemv(A, b, y)
            again = fused.lasso_normal_gemv(A, b, y)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = fused.lasso_normal_gemv(A, b, y)
            graph.replay()
            graph.replay()
            torch.cuda.synchronize()
            launched = counts["lasso_normal_gemv"] - before
            A64, b64, y64 = A.double(), b.double(), y.double()
            want = 2 * (A64.T @ (A64 @ y64 - b64))
            u, k = 2.0**-24, gemv_chain(m, n) + 1
            bound = 2 * (k * u / (1 - k * u)) * (A64.abs().T @ (A64.abs() @ y64.abs() + b64.abs()))
            err = (got.double() - want).abs()
            ratio = float(torch.max(err / bound.clamp_min(1e-300)))
            worst, max_abs = max(worst, ratio), max(max_abs, float(torch.max(err)))
            same = same_bits(got, again) and same_bits(got, replayed)
            log(
                f"phase 5b: lasso_normal_gemv m={m} n={n} (A {4 * offset} bytes past aligned): "
                f"max |g - g64| {float(torch.max(err))!r}, at most {ratio:.4f} of its a-priori bound "
                f"(K={k}); bitwise across launches and a replayed graph: {same}; launches +{launched}"
            )
            if not (ratio <= 1.0 and same and launched == 3):
                raise AssertionError(f"phase 5b: lasso_normal_gemv at m={m} n={n} offset {offset}")

    A, b = lz["A"], lz["b"]
    y = torch.as_tensor(rng.standard_normal(N).astype(np.float32), device=dev)
    times: dict[str, list[float]] = {"kernel": [], "library": []}
    calls = {
        "kernel": lambda: fused.lasso_normal_gemv(A, b, y),
        "library": lambda: fused.lasso_normal_gemv_plain(A, b, y),
    }
    for k in ("kernel", "library", "library", "kernel"):
        times[k].append(event_ms(calls[k], 200))
    k_ms, lib_ms = min(times["kernel"]), min(times["library"])
    bound_ms = 1e3 * M * N * 4 / PEAK_BYTES_PER_S
    log(
        f"phase 5b [{card}]: lasso_normal_gemv at m={M} n={N} f32: {k_ms * 1e3:.2f} us a call "
        f"({[round(t * 1e3, 2) for t in times['kernel']]}; {M * N * 4 / (k_ms * 1e-3) / 1e12:.3f} "
        f"TB/s of A once), the cuBLAS pair with - b and * 2 (library_ms) {lib_ms * 1e3:.2f} us "
        f"({[round(t * 1e3, 2) for t in times['library']]}), in turns; bound {bound_ms * 1e3:.2f} us "
        f"(A's {M * N * 4 / 1e6:.0f} MB once at 3.35 TB/s): {bound_ms / k_ms:.1%} of it"
    )
    return {"err": max_abs, "ratio": worst, "ms": k_ms, "library_ms": lib_ms}


#: Every phase, in the order of the full run (``--phases`` selects some).
PHASES = (
    "1", "2", "3", "4", "5", "5b", "6", "7", "8", "9", "10", "11", "11b",
    "12a", "12b", "12c", "12d", "12e", "12f", "12g",
    "13a", "13b", "13c", "13d", "13e", "13f", "13g",
    "14a", "14b", "14c", "14d", "14e",
    "15a", "15b", "15c", "15d", "15e", "16",
)


def select_phases(spec: str | None) -> set[str]:
    """The phases a ``--phases`` list names: comma-separated phase names
    (``14a``) or numbers (``12``: 12a-f), and ranges of either (``1-5``,
    ``12b-13c``).  None: every phase."""
    if spec is None:
        return set(PHASES)

    def span(tok: str) -> list[int]:
        idx = [i for i, p in enumerate(PHASES) if tok in (p, p.rstrip("abcdefg"))]
        if not idx:
            raise SystemExit(f"chip_smoke: unknown phase {tok!r} (phases: {', '.join(PHASES)})")
        return idx

    out: set[str] = set()
    for part in filter(None, (t.strip() for t in spec.split(","))):
        lo, sep, hi = part.partition("-")
        first, last = span(lo.strip())[0], span((hi if sep else lo).strip())[-1]
        if last < first:
            raise SystemExit(f"chip_smoke: empty range {part!r}")
        out.update(PHASES[first : last + 1])
    if not out:
        raise SystemExit("chip_smoke: --phases selects no phase")
    return out


def pool_tasks(want: set[str], dev, card14: dict) -> list:
    """The pool's tasks that the selected phases need."""
    tasks = []
    if "10" in want:
        tasks += phase10_tasks(dev)
    batches = [t for t in phase12_tasks(dev) if t[0] != "fds_wide"]
    if want & {"12a", "13a"}:
        tasks += batches
    if "12d" in want:
        tasks.append(("fds_wide", str(dev)))
    if "12g" in want:
        tasks += [t for t in phase12g_tasks(dev) if t[3] != "cpu"]
    if "13b" in want:
        tasks.append(("cli", str(dev)))
    if "13c" in want:
        tasks += [t for t in phase13_tasks(dev) if t[0] == "sweep"]
    parts = {"cameraman_sweep": {"14b"}, "wavelet_cpu": {"14a", "14b"}, "wavelet_windows": {"14b"},
             "logistic": {"14c"}, "group_lasso": {"14d"}}
    tasks += [t for t in phase14_tasks(dev, card14) if want & (parts.get(t[0]) or parts[t[1]])]
    return tasks


def kernels_line(runs: dict) -> list[dict]:
    """The ``kernels`` line from what the phases that ran measured: every
    kernel that one of them checked, timed or launched, each number that
    no selected phase measured null (the full run measures them all)."""

    def bound_ms(n: int, dtype: torch.dtype) -> float:
        # y, g, x read and x, y written once (the 0-d scalars and flags add
        # under 100 bytes).
        return 1e3 * 5 * n * (torch.finfo(dtype).bits // 8) / PEAK_BYTES_PER_S

    lasso_err, kern_ms = runs.get("lasso_err"), runs.get("kern_ms")
    launches, card14, card15 = runs["lasso_launches"], runs["card14"], runs["card15"]
    # An entry that runs on several main paths: its launches are their
    # sum, and each path's time and bound stand at that path's n and dtype.
    by_path = {
        "lasso_step_tail": (
            ("Lasso.solve_fixed_step (phase 4)", N, torch.float32, launches.get("lasso_step_tail")),
            ("WaveletDeblur.solve (phase 14a)", WL_SIDE**2, torch.float32, card14.get("wl_launches")),
            ("SparseLogistic.solve fixed step (phase 14c)", N, torch.float32,
             card14.get("logistic_launches")),
        ),
        "fused_prox_momentum": (
            ("Lasso.solve_fixed_step with tol_rel (phase 4)", N, torch.float32,
             launches.get("fused_prox_momentum")),
            ("feature-sharded Lasso.solve_fixed_step, NCCL world of 1 (phase 15b)", N,
             torch.float32, card15.get("b", {}).get("launches")),
            (f"feature-sharded Lasso.solve_fixed_step, {GLOO_RANKS} Gloo ranks on one card, "
             "a rank's block, both ranks' launches (phase 15c)", card15.get("c", {}).get("block"),
             torch.float64, card15.get("c", {}).get("launches")),
        ),
        "fista_tail": (
            ("raw fista_step_dense_fused loop (phase 5)", N, torch.float32, launches.get("fista_tail")),
            ("examples.large_lasso, warm-up and timed run (phase 15a)", LARGE_N, torch.float32,
             card15.get("a", {}).get("launches")),
        ),
    }
    kernels = []
    for name, replaces in LASSO_KERNELS.items():
        paths = [
            {
                "path": path,
                "n": n,
                "dtype": str(dtype)[6:],
                "launches": launched,
                "ms": kern_ms[name][n, dtype][0] if kern_ms else None,
                "plain_ms": kern_ms[name][n, dtype][1] if kern_ms else None,
                "bound_ms": bound_ms(n, dtype),
            }
            for path, n, dtype, launched in by_path[name]
            if launched is not None
        ]
        errs = [lasso_err[name]] if lasso_err else []
        if name == "fista_tail":
            errs += [e for e in (runs.get("step_err"), card15.get("a", {}).get("step_err")) if e is not None]
        if not (paths or errs or kern_ms):
            continue
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": replaces,
                "launches": sum(p["launches"] for p in paths) if paths else None,
                "max_abs_err": max(errs) if errs else None,
                "ms": kern_ms[name][N, torch.float32][0] if kern_ms else None,
                "plain_ms": kern_ms[name][N, torch.float32][1] if kern_ms else None,
                "bound_ms": bound_ms(N, torch.float32),
                "bound_by": "bytes",
                # No single PyTorch call computes the soft-threshold and the
                # momentum step together, let alone the step's tail.
                "library_ms": None,
                "by_path": paths,
            }
        )
    gemv, gemv_launches = runs.get("gemv"), launches.get("lasso_normal_gemv")
    if gemv or gemv_launches is not None:
        kernels.append(
            {
                "name": "lasso_normal_gemv",
                "route": "cuda",
                "source": GEMV_SOURCE,
                # No TPU kernel: the JAX package leaves the step's two
                # matvecs to XLA (zfista_tpu/ops/fused.py:144).
                "replaces": None,
                "launches": gemv_launches,
                "max_abs_err": gemv["err"] if gemv else None,
                "ms": gemv["ms"] if gemv else None,
                # Its plain version is the pair it replaces.
                "plain_ms": gemv["library_ms"] if gemv else None,
                "bound_ms": 1e3 * M * N * 4 / PEAK_BYTES_PER_S,
                "bound_by": "bytes",
                # Two cuBLAS GEMVs and the - b and * 2 launches.
                "library_ms": gemv["library_ms"] if gemv else None,
                "by_path": [
                    {"path": "Lasso.solve_fixed_step (phase 4)", "m": M, "n": N,
                     "dtype": "float32", "launches": gemv_launches}
                ] if gemv_launches is not None else [],
            }
        )
    tv_err, tv_launches, tv_runs, tv_ms, tv_graph_us = (
        runs.get(k) for k in ("tv_err", "tv_launches", "tv_runs", "tv_ms", "tv_graph_us"))
    for name, (source, replaces) in TV_KERNELS.items():
        if not (tv_err or tv_launches):
            continue
        # Each kernel's time at the size and n_iter its main-path run used.
        n, n_iter = tv_runs[name] if tv_runs else (None, None)
        b_ms, b_by = fgp_bound((n, n), torch.float32, n_iter) if tv_runs else (None, None)
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": tv_launches[name] if tv_launches else None,
                "max_abs_err": tv_err[name] if tv_err else None,
                "n_iter": n_iter,
                "ms": tv_ms[n, n_iter][name] if tv_ms and tv_runs else None,
                "plain_ms": tv_ms[n, n_iter]["fgp_plain"] if tv_ms and tv_runs else None,
                # Its main-path launches are nodes of replayed chunk graphs;
                # the µs a call there, by torch.profiler (phase 7's profile).
                "graph_us": tv_graph_us.get(name) if tv_graph_us else None,
                "bound_ms": b_ms,
                "bound_by": b_by,
                # No PyTorch call computes an FGP iteration.
                "library_ms": None,
            }
        )
    return kernels


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one H100.")
    parser.add_argument(
        "--phases",
        help="comma list of phases and ranges to run, e.g. '1-5,14a' (default: every phase); "
        "each computes what it needs of the others",
    )
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    want = select_phases(args.phases)
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False)"
        )

    from zfista_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    # The precision policy (zfista_tpu_torch/ops/precision.py), stated and
    # set: full-fp32 cuBLAS products and cuDNN convolutions, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- phase 1: the card and the build (every run) ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi!r}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"phases {[p for p in PHASES if p in want]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(
        f"phase 1 [{smi}]: built {[p.name for p in paths]} in "
        f"{time.perf_counter() - t0:.3f} s (in parallel)"
    )

    lasso_ctx: dict = {}

    def lz() -> dict:  # the LASSO problem, made once by the first phase that needs it
        if not lasso_ctx:
            lasso_ctx.update(lasso_setup(dev))
        return lasso_ctx

    runs: dict = {"lasso_launches": {}, "card14": {}, "card15": {}}
    card14, card15 = runs["card14"], runs["card15"]
    pooled: dict = {}
    background: dict = {}
    walls: dict = {}
    parts14 = {p for p in ("14a", "14b", "14c", "14d") if p in want}

    def pool_run() -> None:
        tasks = pool_tasks(want, dev, card14)
        if tasks:
            pooled.update(run_pool(smi, dev, tasks))
        if "12g" in want:  # 12g's CPU side, beside the main process's phases 10-12d
            background["12g"] = start_background([t for t in phase12g_tasks(dev) if t[3] == "cpu"])

    # The order of the full run: phases 2-8, then those timed in this
    # process before the first profiled region (timings taken after one
    # come out slower; phase 9 profiles), then the profiles, the pool of
    # worker processes (phases 10, 12, 13 and 14's CPU work) and what reads
    # it, and scale-out last.
    steps = (
        ("2", "2", lambda: runs.update(lasso_err=phase2(dev))),
        ("3", "3", lambda: runs.update(step_err=phase3(dev, lz()))),
        ("4", "4", lambda: runs["lasso_launches"].update(phase4(smi, dev, lz()))),
        ("5", "5", lambda: runs.update(zip(("fista", "kern_ms"), phase5(smi, dev, lz())))),
        ("5b", "5b", lambda: runs.update(gemv=phase5b(smi, dev, lz()))),
        ("6", "6", lambda: runs.update(tv_err=phase6(dev))),
        ("7", "7", lambda: runs.update(zip(("tv_launches", "tv_runs", "tv_step_ms"), phase7(dev, smi)))),
        ("8", "8", lambda: runs.update(tv_ms=phase8(dev, smi))),
        ("14a", "14a", lambda: card14.update(phase14a(smi, dev))),
        ("14c", "14c", lambda: card14.update(phase14c(smi, dev))),
        ("14d", "14d", lambda: card14.update(phase14d(smi, dev))),
        ("14e", "14e", lambda: phase14e(smi)),
        ("12b", "12b", lambda: phase12b(smi, dev)),
        ("12c", "12c", lambda: phase12c(smi, dev)),
        ("12f", "12f", lambda: phase12f(smi, dev, lz())),
        ("13d", "13d", lambda: phase13d(smi)),
        ("13e", "13e", lambda: phase13e(smi)),
        ("9", "9", lambda: phase9(dev, smi, lz()["A"], lz()["b"], lz()["A_np"], lz()["b_np"], lz()["lr"])),
        ("4", "4 (profile)", lambda: phase4_profile(smi, dev, lz())),
        ("7", "7 (profile)", lambda: runs.update(tv_graph_us=phase7_profile(smi, dev, runs["tv_step_ms"]))),
        # Phase 5's profile, here because timings taken after a profiled
        # region in the same process come out slower, and phase 9 profiles.
        ("5", "5 (loops)", lambda: lasso_loops(dev, smi)),
        ("pool", "10, 12, 13 and 14's pool", pool_run),
        ("10", "10", lambda: walls.update(phase10(smi, dev, pooled))),
        ("12a", "12a", lambda: phase12a(smi, dev, pooled, walls)),
        ("13a", "13a", lambda: phase13a(smi, dev, pooled)),
        ("13b", "13b", lambda: phase13b(smi, pooled[("cli", str(dev))])),
        ("13c", "13c", lambda: phase13c(smi, dev, pooled)),
        ("14", "14a-d", lambda: phase14(smi, dev, card14, pooled, parts14)),
        ("11", "11", lambda: phase11(smi, dev)),
        ("11b", "11b", lambda: phase11b(smi, dev)),
        ("12d", "12d", lambda: phase12d(smi, dev, pooled[("fds_wide", str(dev))])),
        # 12g's CPU side has run beside 10-12d; 12e counts profiler events
        # with the host to itself.
        ("12g", "12g", lambda: phase12g(smi, dev, {**pooled, **finish_background(smi, background.pop("12g"))})),
        ("12e", "12e", lambda: phase12e(smi, dev)),
        ("13f", "13f", lambda: phase13f(smi, dev, lz()["A"], lz()["b"], lz()["lr"])),
        ("13g", "13g", lambda: phase13g(smi)),
        ("15a", "15a", lambda: card15.update(a=phase15a(smi, dev))),
        ("15b", "15b", lambda: card15.update(b=phase15b(smi, dev, lz()["A_np"], lz()["b_np"], lz()["lr"]))),
        ("15c", "15c", lambda: card15.update(c=phase15c(smi, dev))),
        ("15d", "15d", lambda: card15.update(d=phase15d(smi))),
        ("15e", "15e", lambda: phase15e(smi, dev)),
        ("16", "16", lambda: phase16(smi, dev)),
    )
    # Steps that more than their own name selects: 14a's card run serves
    # 14b too, the pool runs what the selected phases need of it.
    needs = {"14a": bool(want & {"14a", "14b"}), "pool": bool(pool_tasks(want, dev, {})),
             "14": bool(parts14)}
    seconds = []
    for key, label, run in steps:
        if not needs.get(key, key in want):
            continue
        t0 = time.perf_counter()
        run()
        seconds.append((label, time.perf_counter() - t0))
        log(f"phase {label} [{smi}]: done in {seconds[-1][1]:.1f} s")

    runs["lasso_launches"]["fista_tail"] = runs.get("fista")
    if runs["lasso_launches"]["fista_tail"] is None:
        del runs["lasso_launches"]["fista_tail"]
    for label, sec in seconds:
        print(f"phase seconds: {label}: {sec:.1f}")
    print(f"phase seconds: all phases: {sum(sec for _, sec in seconds):.1f} "
          f"(the script {time.perf_counter() - t_start:.1f})")
    print(json.dumps({"kernels": kernels_line(runs)}))
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
