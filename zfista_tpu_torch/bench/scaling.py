r"""Weak scaling: lane-iterations/s per device as the world grows (PyTorch port).

Counterpart of :mod:`zfista_tpu.bench.scaling`.  The work per device is
held constant (``lanes_per_device`` lanes of the batched fixed-step FISTA
iteration on dense LASSO, :func:`zfista_tpu_torch.models.lasso.fista_step_dense`
over the lanes: two cuBLAS GEMMs with the shared operator and the
elementwise tail) and the number of devices grows; throughput per device
is compared with the smallest world's.

For each device count ``d`` the harness starts ``d`` processes (spawned):
on ``device="cuda"`` one card each over NCCL, on ``device="cpu"`` one CPU
thread each over Gloo.  Lanes are independent, so a rank runs its own
and nothing crosses ranks inside the timed window: what grows is only the
barrier at each end, the weak-scaling ideal.  The window goes from
barrier to barrier after one untimed run, and the slowest rank's time
counts (an all-reduce of the maximum); the best of ``repeats`` windows is
reported.

CLI: ``python -m zfista_tpu_torch.bench.scaling [--devices 1,2,4,8] [--device cuda]``
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue as queue_mod
import time
from typing import Sequence

import numpy as np
import torch

#: Seconds a rank process may take for its whole run before the harness
#: gives up on it.
_RANK_TIMEOUT_S = 900


def _rank_run(rank: int, world: int, port: int, device: str, cfg: dict, out) -> None:
    """One rank of a ``world``-process run: its lanes' ``n_iter`` steps,
    ``repeats`` timed windows; rank 0 puts the slowest rank's best window
    on ``out``."""
    import torch.distributed as dist

    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.parallel import distributed
    from zfista_tpu_torch.parallel.sharding import all_reduce_max, rank_device

    if device == "cpu":
        torch.set_num_threads(1)
    # The rendezvous's store is the parent's (see _world_seconds).
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    cuda = device == "cuda"
    distributed.initialize(
        f"localhost:{port}", world, rank,
        local_device_ids=[rank] if cuda else None, backend="nccl" if cuda else "gloo",
    )
    try:
        dev = rank_device(device)
        rng = np.random.default_rng(cfg["seed"])
        m, n, lanes = cfg["m_rows"], cfg["n_features"], cfg["lanes_per_device"]
        A_np = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b_np = rng.standard_normal(m).astype(np.float32)
        A = torch.as_tensor(A_np, device=dev)
        b = torch.as_tensor(b_np, device=dev)
        lam = torch.tensor(0.01, dtype=torch.float32, device=dev)
        lr = torch.tensor(0.25, dtype=torch.float32, device=dev)  # a fixed stable step
        step = torch.func.vmap(
            lambda x, y, t: fista_step_dense(A, b, lam, lr, (x, y, t))
        )
        X0 = torch.zeros((lanes, n), dtype=torch.float32, device=dev)
        t0 = torch.ones((lanes,), dtype=torch.float32, device=dev)

        def run():
            c = (X0, X0, t0)
            for _ in range(cfg["n_iter"]):
                c = step(*c)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return c

        run()  # warm-up: cuBLAS handles, allocator pools
        best = np.inf
        for _ in range(cfg["repeats"]):
            dist.barrier()
            start = time.perf_counter()
            run()
            dist.barrier()
            dt = torch.tensor([time.perf_counter() - start], dtype=torch.float64, device=dev)
            best = min(best, float(all_reduce_max(dt, dist.group.WORLD)[0]))
        if rank == 0:
            out.put(best)
    finally:
        distributed.shutdown()


def _world_seconds(world: int, device: str, cfg: dict) -> float:
    """Start ``world`` rank processes and return the slowest rank's best
    window.  The rendezvous's store is served from this process, on a port
    that the OS picks and that stays bound here until the ranks have
    ended; the ranks join it as clients (``TORCHELASTIC_USE_AGENT_STORE``,
    which torch's ``tcp://`` rendezvous reads), so no other process can
    take the port before they start."""
    from torch.distributed import TCPStore

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False)
    port = store.port
    procs = [
        ctx.Process(target=_rank_run, args=(r, world, port, device, cfg, out))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + _RANK_TIMEOUT_S
        while True:
            try:
                seconds = out.get(timeout=1.0)  # drained before the joins
                break
            except queue_mod.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"weak_scaling: a {world}-process run failed "
                        f"(exit codes {[p.exitcode for p in procs]})"
                    )
        for p in procs:
            p.join(timeout=_RANK_TIMEOUT_S)
            if p.exitcode != 0:
                raise RuntimeError(f"weak_scaling: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        del store
    return seconds


def weak_scaling(
    device_counts: Sequence[int] = (1, 2, 4, 8),
    lanes_per_device: int = 64,
    n_features: int = 2048,
    m_rows: int = 512,
    n_iter: int = 200,
    repeats: int = 3,
    seed: int = 0,
    device: str = "cuda",
) -> list[dict]:
    """Per-device throughput of the batched FISTA step at constant work per
    device.  Returns one row per device count:
    ``{devices, lanes, seconds, lane_iters_per_s, per_device, efficiency}``.

    ``device="cuda"`` needs as many cards as the largest count; ``"cpu"``
    as many CPU cores.  A larger count raises ``ValueError``.
    """
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("weak_scaling(device='cuda'): no CUDA device")
        have = torch.cuda.device_count()
    elif device == "cpu":
        have = os.cpu_count() or 1
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    if max(device_counts) > have:
        raise ValueError(f"requested {max(device_counts)} devices, have {have}")
    cfg = dict(
        lanes_per_device=int(lanes_per_device), n_features=int(n_features),
        m_rows=int(m_rows), n_iter=int(n_iter), repeats=int(repeats), seed=int(seed),
    )
    rows: list[dict] = []
    base_per_device = None
    # Efficiency is relative to the SMALLEST device count (normally 1).
    for d in sorted(device_counts):
        best = _world_seconds(d, device, cfg)
        B = lanes_per_device * d
        lane_iters_per_s = B * n_iter / best
        per_device = lane_iters_per_s / d
        if base_per_device is None:
            base_per_device = per_device
        rows.append(
            dict(
                devices=d,
                lanes=B,
                seconds=best,
                lane_iters_per_s=lane_iters_per_s,
                per_device=per_device,
                efficiency=per_device / base_per_device,
            )
        )
    return rows


def format_table(rows: list[dict]) -> str:
    lines = [
        "| devices | lanes | time [s] | lane-iters/s | per device | efficiency |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['devices']} | {r['lanes']} | {r['seconds']:.3f} "
            f"| {r['lane_iters_per_s']:,.0f} | {r['per_device']:,.0f} "
            f"| {100 * r['efficiency']:.1f}% |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="weak-scaling harness")
    parser.add_argument("--devices", default="1,2,4,8")
    parser.add_argument("--lanes-per-device", type=int, default=64)
    parser.add_argument("--n-features", type=int, default=2048)
    parser.add_argument("--m-rows", type=int, default=512)
    parser.add_argument("--n-iter", type=int, default=200)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cards over NCCL, or CPU processes over Gloo")
    args = parser.parse_args(argv)
    rows = weak_scaling(
        device_counts=[int(c) for c in args.devices.split(",")],
        lanes_per_device=args.lanes_per_device,
        n_features=args.n_features,
        m_rows=args.m_rows,
        n_iter=args.n_iter,
        device=args.device,
    )
    print(format_table(rows))


if __name__ == "__main__":
    main()
