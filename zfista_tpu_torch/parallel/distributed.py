r"""Multi-process runtime on ``torch.distributed`` (PyTorch port).

Counterpart of :mod:`zfista_tpu.parallel.distributed`: one process per
device, one process group, one global mesh, so the same solver program
spans processes and hosts.  Where JAX's runtime discovers a TPU slice,
``torch.distributed`` is told its rendezvous, world size and rank::

    # one command per process (host 0 shown; the coordinator is rank 0's)
    python train.py --coordinator=10.0.0.1:8476 --num-processes=2 --process-id=0

    # in train.py:
    from zfista_tpu_torch.parallel import distributed
    distributed.initialize(coordinator_address, num_processes, process_id)
    mesh = distributed.global_mesh(model=1)            # every process's device
    x0s = distributed.distribute_batch(x0_host, mesh)  # this rank's lanes
    res = minimize_proximal_gradient_batch(..., x0s)   # the whole batch, on every rank

NCCL carries the collectives between CUDA ranks and Gloo between CPU
ranks; every collective of the port is an all-reduce
(:mod:`zfista_tpu_torch.parallel.sharding`), which Gloo also takes on CUDA
tensors, so ranks that share one card can run over Gloo.
``tests/test_torch_distributed.py`` runs this module's worker (``python -m
zfista_tpu_torch.parallel.distributed``) as 2 and 4 CPU processes over
Gloo and holds their sharded solves against unsharded ones.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from zfista_tpu_torch.parallel.sharding import (
    P,
    Mesh,
    NamedSharding,
    batch_sharding,
    distribute,
    gather_along,
    make_mesh,
    rank_device,
)

#: The arguments of the :func:`initialize` call that made this process's
#: world (the process group is process-wide, as torch.distributed's own).
_INIT: tuple | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    backend: str | None = None,
) -> None:
    """Join (or create) the process group.

    ``coordinator_address`` (``host:port`` of rank 0's rendezvous),
    ``num_processes`` and ``process_id``, or, left out, torchrun's
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.

    ``backend`` defaults to NCCL on a machine with a card and Gloo on one
    without.  A rank is a CUDA rank under NCCL, or when
    ``local_device_ids`` names its card: its device is
    ``cuda:local_device_ids[0]``, or ``cuda:<local rank>`` (``LOCAL_RANK``,
    else ``process_id``, modulo the card count), made the current device.
    A Gloo rank without ``local_device_ids`` leaves the current device as
    it is, and its data go where the caller puts them
    (:func:`~zfista_tpu_torch.parallel.sharding.rank_device`'s ``device``).

    Idempotent: a second call with the same arguments does nothing; one
    with other arguments, or after a process group this module did not
    make, raises.
    """
    global _INIT
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    num_processes = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    process_id = int(env["RANK"] if process_id is None else process_id)
    if coordinator_address is None:
        raise ValueError("initialize needs coordinator_address (or MASTER_ADDR/MASTER_PORT)")
    args = (
        coordinator_address, num_processes, process_id,
        None if local_device_ids is None else tuple(int(d) for d in local_device_ids),
        backend,
    )
    if dist.is_initialized():
        if args == _INIT:
            return
        raise RuntimeError(
            f"torch.distributed is already initialized (by {_INIT!r}); "
            f"initialize{args!r} differs"
        )
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    kw = {}
    if backend == "nccl" or local_device_ids:
        if not cuda:
            raise RuntimeError(f"a CUDA rank (backend {backend!r}) needs a CUDA device and there is none")
        local = (
            int(local_device_ids[0]) if local_device_ids
            else int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()
        )
        torch.cuda.set_device(local)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw,
    )
    _INIT = args


def shutdown() -> None:
    """Leave the process group :func:`initialize` made (a no-op without
    one), so that the backend's connections close before the process
    exits."""
    global _INIT
    if dist.is_initialized():
        dist.destroy_process_group()
    _INIT = None


def global_mesh(batch: int | None = None, model: int = 1) -> Mesh:
    """A ``("batch", "model")`` mesh over every process's device
    (:func:`zfista_tpu_torch.parallel.sharding.make_mesh` over the world)."""
    return make_mesh(batch=batch, model=model)


def distribute_global(arr: Any, mesh: Mesh, spec: Sequence[str | None], device: Any = None) -> torch.Tensor:
    """This rank's block of a global array laid out by ``spec`` (a
    :class:`~zfista_tpu_torch.parallel.sharding.PartitionSpec`) over
    ``mesh``, from identical host data on every process.

    Each rank copies only its own block to its device (``device``, default
    the rank's: :func:`~zfista_tpu_torch.parallel.sharding.rank_device`),
    tagged with its placement; no rank materializes a remote block.  With
    a world of one it is the whole array.  Use it to lay a dense operator
    out by columns (``P(None, "model")``), an iterate by features
    (``P("model")``) or a scenario batch by lanes (``P("batch")``).
    """
    return distribute(arr, NamedSharding(mesh, P(*spec)), device)


def distribute_batch(x0s: Any, mesh: Mesh, device: Any = None) -> torch.Tensor:
    """:func:`distribute_global` with the scenario-batch placement
    ``P("batch")``: this rank's lanes."""
    return distribute(x0s, batch_sharding(mesh), device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_processes_allclose(local_value: Any, **kw) -> bool:
    """True on every process iff every process's ``local_value`` matches
    process 0's (a gather over the world and a compare; a diagnostic for
    parity checks).  ``np.allclose`` semantics: pass ``rtol=0`` as well as
    ``atol=0`` for an exact match."""
    if not dist.is_initialized():
        return True  # a world of one
    # The backend's own device: NCCL takes CUDA tensors, Gloo CPU ones.
    on = rank_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    v = torch.as_tensor(np.asarray(local_value)).to(on)
    world = dist.get_world_size()
    gathered = gather_along(v[None], 0, dist.group.WORLD, world, dist.get_rank()).cpu().numpy()
    return all(np.allclose(gathered[0], gathered[i], **kw) for i in range(world))


# ---------------------------------------------------------------------------
# Worker entry: ``python -m zfista_tpu_torch.parallel.distributed`` — run by
# tests/test_torch_distributed.py as real processes over Gloo on the CPU, and
# a template for multi-host launches.
# ---------------------------------------------------------------------------


def _parity_worker(args: argparse.Namespace) -> None:
    """Solve a LASSO λ-sweep batch and an m=3 momentum-pair batch sharded
    over every rank, and a LASSO feature-sharded over every rank, each
    against the same solve unsharded on this rank's device."""
    from zfista_tpu_torch.models import TRIDIA
    from zfista_tpu_torch.models.lasso import Lasso, make_lasso_lambda_sweep
    from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch

    cards = None if args.platform == "cpu" else [args.process_id % torch.cuda.device_count()]
    initialize(args.coordinator, args.num_processes, args.process_id,
               local_device_ids=cards, backend=args.backend)
    dev = rank_device(args.platform)
    n_dev = process_count()
    mesh = global_mesh(batch=n_dev, model=1)
    bsh = batch_sharding(mesh)

    # Identical data on every process from a shared seed; float64, so the
    # feature-sharded solve's reduce order cannot move its iteration count.
    rng = np.random.default_rng(0)
    m, n = 16, 8
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    f, g, jac_f, prox = make_lasso_lambda_sweep(A, b, device=dev)
    B = 2 * n_dev
    lams = np.linspace(0.05, 0.5, B)
    x0s = np.zeros((B, n))
    lr = 0.9 / float(2 * np.linalg.norm(A, 2) ** 2)  # 0.9/L, L = 2*sigma^2

    solve = lambda x0_arr, lam_arr, **kw: minimize_proximal_gradient_batch(
        f, g, jac_f, prox, x0_arr, batch_params=lam_arr,
        lr=lr, nesterov=True, max_iter=20000, keep_state=False, **kw,
    )
    # Distributed: lanes over every rank; the local reference: every lane here.
    res_dist = solve(distribute_batch(x0s, mesh, dev), distribute_batch(lams, mesh, dev))
    res_local = solve(torch.as_tensor(x0s, device=dev), torch.as_tensor(lams, device=dev))
    assert res_dist.x.shape == (B, n)
    np.testing.assert_array_equal(res_dist.x, res_local.x)
    np.testing.assert_array_equal(res_dist.nit, res_local.nit)
    assert bool(np.all(res_dist.success))
    assert all_processes_allclose(res_dist.x, atol=0, rtol=0)

    # The m=3 momentum-pair batch (__graft_entry__.dryrun_multichip): the
    # semismooth-Newton dual's host loops run per rank on its own lanes.
    mo = TRIDIA()
    B_mo = 16 * n_dev
    x0_mo = rng.uniform(-1.0, 1.0, (B_mo, mo.n_features))
    ab = np.tile(np.asarray([[0.5, 0.25], [0.0, 0.25]]), (B_mo // 2, 1))
    solve_mo = lambda sharding: minimize_proximal_gradient_batch(
        mo.f, mo.g, mo.jac_f, mo.prox_wsum_g, torch.as_tensor(x0_mo, device=dev),
        batch_nesterov_ratio=ab, in_sharding=sharding, nesterov=True, max_iter=5000,
    )
    res_sh, res_si = solve_mo(bsh), solve_mo(None)
    assert bool(np.all(res_sh.success)), "m=3: unconverged lanes"
    np.testing.assert_array_equal(res_sh.nit, res_si.nit)
    np.testing.assert_array_equal(res_sh.x, res_si.x)
    assert all_processes_allclose(res_sh.x, atol=0, rtol=0)
    print(f"PARITY_OK process={args.process_id}/{args.num_processes} "
          f"devices={n_dev} batch={B} m3_batch={B_mo}", flush=True)

    # --- Tensor-parallel (model-axis) case -------------------------------
    # The operator's feature axis over every rank (A by columns, x by
    # features): the partial matvecs all-reduce across the processes.
    mesh_tp = global_mesh(batch=1, model=n_dev)
    L = float(2 * np.linalg.norm(A, 2) ** 2)
    res_tp = Lasso(
        distribute_global(A, mesh_tp, P(None, "model"), dev), torch.as_tensor(b, device=dev),
        l1_ratio=0.05,
    ).solve_fixed_step(
        distribute_global(np.zeros(n), mesh_tp, P("model"), dev), lr=1.0 / L, max_iter=20000
    )
    res_tp_local = Lasso(torch.as_tensor(A, device=dev), torch.as_tensor(b, device=dev),
                         l1_ratio=0.05).solve_fixed_step(
        torch.zeros(n, dtype=torch.float64, device=dev), lr=1.0 / L, max_iter=20000
    )
    assert res_tp.success and res_tp_local.success
    assert res_tp.nit == res_tp_local.nit, f"TP nit diverged: {res_tp.nit} vs {res_tp_local.nit}"
    np.testing.assert_allclose(res_tp.x, res_tp_local.x, rtol=0, atol=1e-9)
    assert all_processes_allclose(res_tp.x, atol=0, rtol=0)
    if args.out and args.process_id == 0:
        np.savez(args.out, x=res_tp.x, nit=res_tp.nit, A=A, b=b, lr=1.0 / L)
    print(f"TP_PARITY_OK process={args.process_id}/{args.num_processes} "
          f"model={n_dev}", flush=True)
    shutdown()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="zfista_tpu_torch distributed worker (parity check / launch template)"
    )
    parser.add_argument("--coordinator", required=True, help="host:port of rank 0's rendezvous")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                        help="the ranks' device: one card each, or the CPU")
    parser.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                        help="default: nccl on cuda, gloo on cpu")
    parser.add_argument("--out", default=None,
                        help="rank 0 writes the feature-sharded solve's x and nit here (.npz)")
    args = parser.parse_args(argv)
    if args.platform == "cpu":
        # CPU ranks even on a machine with a card: hide it before torch
        # first asks CUDA for its devices.
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    elif not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device")
    _parity_worker(args)


if __name__ == "__main__":
    main()
