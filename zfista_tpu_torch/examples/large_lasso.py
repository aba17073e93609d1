r"""Large dense LASSO: a million features, the operator's columns sharded.

Counterpart of the JAX package's ``examples/large_lasso.py``:
``min_x ||A x − b||² + λ‖x‖₁`` with dense ``A (m, n)``, ``n`` up to 10⁶
(8 GB in float32 at m = 2,000, which one H100's 80 GB holds), by raw
fixed-step FISTA steps: :func:`zfista_tpu_torch.ops.fused.fista_step_dense_fused`,
two full-fp32 cuBLAS GEMVs and the fused CUDA tail (``fista_tail``) per
step.  On one card this is a pass over HBM: ``A`` is read twice per step.
With ``--model-shards k`` the features, and ``A``'s columns, are split over
``k`` ranks (``A @ y`` all-reduced between the GEMVs); the script is the
same either way.

``A`` is built on the device, each rank only its own columns: columns are
drawn in fixed blocks of :data:`COLUMN_BLOCK`, each block from a
``torch.Generator`` seeded by ``(seed, block)``, so every shard count holds
the same ``A`` and no host copy of it is made.  ``1/L`` comes from the
(sharded) power iteration.  One untimed run, then a timed run of ``--iters``
steps (CUDA events on a card).

Prints one JSON line: iterations/s, achieved HBM GB/s (two passes over
``A`` per step), the warm-up's seconds and the final objective, beside the
device (``nvidia-smi``'s name and power limit on a card).

Usage::

    python -m zfista_tpu_torch.examples.large_lasso [--n 1000000] [--m 2000]
        [--iters 200] [--model-shards 1] [--lam 0.01] [--device cuda]

``--model-shards k > 1`` runs under an initialized world of ``k`` (or a
multiple of ``k``) processes, e.g. ``torchrun --nproc-per-node k -m
zfista_tpu_torch.examples.large_lasso --model-shards k``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from zfista_tpu_torch.models.lasso import operator_norm_sq
from zfista_tpu_torch.ops.fused import fista_step_dense_fused
from zfista_tpu_torch.ops.precision import matmul_hp
from zfista_tpu_torch.parallel.sharding import (
    NamedSharding,
    feature_sharding,
    feature_sum,
    make_mesh,
    operator_sharding,
    tag,
)

#: Columns per generator block of ``A`` (a block's draw is shaped (m, 8192)
#: whatever the shard count).
COLUMN_BLOCK = 8192


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) << 32) | int(stream))


def build_operator(
    m: int, n: int, seed: int, sharding: NamedSharding | None, device, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's column block of ``A`` (``sharding``: an
    ``operator_sharding``; None: the whole ``A``), standard normal over
    ``√m``, and the whole ``b``, both on ``device``.  Only the rank's
    columns are generated (and the rest of the blocks they fall in)."""
    device = torch.device(device)
    k = 1 if sharding is None else sharding.mesh.size("model")
    i = 0 if sharding is None else sharding.mesh.index("model")
    if n % k:
        raise ValueError(f"n={n} does not divide into {k} model shards")
    c0, c1 = i * (n // k), (i + 1) * (n // k)
    A = torch.empty((m, c1 - c0), dtype=dtype, device=device)
    for j in range(c0 // COLUMN_BLOCK, (c1 - 1) // COLUMN_BLOCK + 1):
        j0, j1 = j * COLUMN_BLOCK, min((j + 1) * COLUMN_BLOCK, n)
        cols = torch.randn(
            (m, j1 - j0), generator=_generator(device, seed, j), dtype=dtype, device=device
        )
        lo, hi = max(j0, c0), min(j1, c1)
        A[:, lo - c0 : hi - c0] = cols[:, lo - j0 : hi - j0]
    A /= float(np.sqrt(m))
    b = torch.randn(m, generator=_generator(device, seed, 2**32 - 1), dtype=dtype, device=device)
    if sharding is not None:
        tag(A, sharding)
    return A, b


def iterate(A, b, lam, lr, x0, iters: int):
    """``iters`` raw FISTA steps from ``x0`` (``t = 1``): ``(x, y, t)``."""
    c = (x0, x0, torch.ones((), dtype=A.dtype, device=A.device))
    for _ in range(iters):
        c = fista_step_dense_fused(A, b, lam, lr, c)
    return c


def objective(A, b, lam, x) -> float:
    """``||A x − b||² + λ‖x‖₁`` (sums over features all-reduced)."""
    r = feature_sum(A, matmul_hp(A, x)) - b
    return float(torch.sum(r * r) + lam * feature_sum(A, torch.sum(torch.abs(x))))


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--m", type=int, default=2000)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--model-shards", type=int, default=1)
    parser.add_argument("--lam", type=float, default=0.01)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from zfista_tpu_torch.parallel import distributed
    from zfista_tpu_torch.parallel.sharding import rank_device

    if args.device == "cuda":
        # The precision policy: full-fp32 cuBLAS products (no TF32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    world = "WORLD_SIZE" in os.environ
    if args.model_shards > 1 and not world:
        raise SystemExit(
            "--model-shards > 1 runs under an initialized world: start it with "
            "torchrun (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)"
        )
    if world:
        distributed.initialize(backend="nccl" if args.device == "cuda" else "gloo")
    try:
        dev = rank_device(args.device)
        mesh = make_mesh(model=args.model_shards)
        m, n = args.m, args.n
        A, b = build_operator(m, n, 0, operator_sharding(mesh), dev)
        L = 2 * operator_norm_sq(A, 30)
        lr = (1.0 / L).to(torch.float32)
        lam = torch.tensor(args.lam, dtype=torch.float32, device=dev)
        x0 = tag(torch.zeros(A.shape[1], dtype=torch.float32, device=dev), feature_sharding(mesh))

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        t0 = time.perf_counter()
        iterate(A, b, lam, lr, x0, args.iters)
        sync()
        warmup_s = time.perf_counter() - t0
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = iterate(A, b, lam, lr, x0, args.iters)
            end.record()
            sync()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = iterate(A, b, lam, lr, x0, args.iters)
            dt = time.perf_counter() - t0
        iters_per_s = args.iters / dt
        # Two full passes over A per iteration (A @ y and Aᵀ r), float32.
        gb_per_iter = 2 * m * n * 4 / 1e9
        record = {
            "metric": "large_lasso_iterations_per_s",
            "n": n,
            "m": m,
            "model_shards": args.model_shards,
            "value": iters_per_s,
            "unit": "iter/s",
            "achieved_GBps": iters_per_s * gb_per_iter,
            "warmup_s": warmup_s,
            "final_obj": objective(A, b, lam, out[0]),
            "device": _card(dev),
        }
        if distributed.process_count() == 1 or torch.distributed.get_rank() == 0:
            print(json.dumps(record), flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
