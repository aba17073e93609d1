"""The port's ``GroupLasso`` and group λ sweep on a feature-sharded
operator, over four real processes (Gloo on the CPU, float64), held
against the JAX package's unsharded ``GroupLasso`` (JAX x64: equal ``nit``
and trial counts, x within 1e-10).

n = 24 in blocks of 12 (two ranks, each batch row of a 2x2 mesh) and of 6
(four ranks): groups of 4 and 6 align with the blocks, groups of 8 and 24
straddle them (8 over blocks of 6: a block holds the ends of two groups;
24: one group over all four blocks, two of which hold only its middle).
Where the blocks hold whole groups the prox is bitwise the unsharded prox
on them and runs no collective; where a group straddles, one all-reduce
per prox call sums its squares.

The four processes run this file (``python
tests/test_torch_group_lasso_sharded.py --rank r --world 4 --port p --out
dir``); rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zfista_tpu_torch.models import lasso as tl  # noqa: E402
from zfista_tpu_torch.ops.prox import prox_group_lasso  # noqa: E402
from zfista_tpu_torch.parallel import distributed as td  # noqa: E402
from zfista_tpu_torch.parallel import sharding as ts  # noqa: E402
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch  # noqa: E402
from zfista_tpu_torch.parallel.sharding import P  # noqa: E402

CPU = "cpu"
M, N, LAM = 30, 24, 0.2
#: (ranks over "model", group size): aligned, then straddling layouts.
LAYOUTS = ((2, 4), (4, 6), (2, 8), (4, 8), (4, 24))
ALIGNED = {(2, 4), (4, 6)}
SWEEP_LANES = 4
TOL = 1e-6


def _data():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    x_true = np.zeros(N)
    x_true[:8] = rng.standard_normal(8)
    x_true[16:20] = rng.standard_normal(4)
    return A, A @ x_true + 0.01 * rng.standard_normal(M)


def _lr(A):
    return 1.0 / float(2 * np.linalg.norm(A, 2) ** 2)


def _worker(rank: int, world: int, port: int, out: Path) -> None:
    torch.set_num_threads(1)
    td.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        # Every rank makes every mesh, in one order (new_group).
        meshes = {2: [ts.make_mesh(batch=1, model=2, devices=[0, 1]),
                      ts.make_mesh(batch=1, model=2, devices=[2, 3])][rank // 2],
                  4: ts.make_mesh(batch=1, model=4)}
        A, b = _data()
        res = {}
        for k, gs in LAYOUTS:
            mesh = meshes[k]
            prob = tl.GroupLasso(td.distribute_global(A, mesh, P(None, "model"), device=CPU),
                                 torch.as_tensor(b), LAM, gs)
            back = prob.solve(np.zeros(N), nesterov=True, tol=TOL)
            fixed = prob.solve(np.zeros(N), nesterov=True, tol=TOL, decay_rate=1, lr=_lr(A))
            # The prox on a rank's block against the unsharded prox, and
            # the all-reduces it issues.
            x = torch.as_tensor(np.random.default_rng(7).standard_normal(N))
            fsh = ts.feature_sharding(mesh)
            before = ts.collective_counts["sum"]
            got = prob.prox_wsum_g(0.8, ts.block(x, fsh))
            calls = ts.collective_counts["sum"] - before
            whole = ts.block(prox_group_lasso(x, 0.8 * LAM, gs), fsh)
            bitwise = torch.equal(got, whole)
            err = float(torch.max(torch.abs(got - whole)))
            # g over the ranks against the unsharded g.
            g_err = abs(float(prob.g(ts.block(x, fsh))[0])
                        - float(tl.GroupLasso(torch.as_tensor(A), torch.as_tensor(b), LAM, gs).g(x)[0]))
            flags = np.array([bitwise, calls, err, g_err], dtype=np.float64)
            # Every rank's prox facts, on rank 0.
            flags = ts.gather_along(torch.as_tensor(flags)[None], 0, mesh.group("model"), k,
                                    mesh.index("model")).numpy()
            tag = f"k{k}_gs{gs}"
            res.update({f"{tag}_back_x": back.x, f"{tag}_back_nit": back.nit,
                        f"{tag}_back_nit_internal": back.nit_internal, f"{tag}_back_status": back.status,
                        f"{tag}_fixed_x": fixed.x, f"{tag}_fixed_nit": fixed.nit,
                        f"{tag}_fixed_status": fixed.status, f"{tag}_prox": flags})
            assert td.all_processes_allclose(back.x, atol=0, rtol=0)
        # The group sweep with straddling groups, lanes over a 1x2 mesh.
        mesh = meshes[2]
        sweep = tl.make_group_lasso_lambda_sweep(
            td.distribute_global(A, mesh, P(None, "model"), device=CPU), torch.as_tensor(b), 8)
        sw = minimize_proximal_gradient_batch(
            *sweep, np.zeros((SWEEP_LANES, N)), batch_params=torch.linspace(0.02, 0.2, SWEEP_LANES,
                                                                          dtype=torch.float64),
            lr=_lr(A), nesterov=True, max_iter=20000)
        res.update(sweep_x=sw.x, sweep_nit=sw.nit, sweep_status=sw.status)
        if rank == 0:
            np.savez(out / "group_sharded.npz", **res)
        print(f"GROUP_SHARDED_OK rank={rank}", flush=True)
    finally:
        td.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("group_sharded")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", "4", "--port", str(port),
             "--out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(4)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-3000:]}"
        assert f"GROUP_SHARDED_OK rank={r}" in text
    return dict(np.load(out / "group_sharded.npz"))


@functools.lru_cache(maxsize=None)
def _jax_solves(gs: int):
    """The JAX package's unsharded backtracking and fixed-step solves."""
    from zfista_tpu.models.lasso import GroupLasso

    A, b = _data()
    j = GroupLasso(A, b, LAM, gs)
    return (j.solve(np.zeros(N), nesterov=True, tol=TOL),
            j.solve(np.zeros(N), nesterov=True, tol=TOL, decay_rate=1, lr=_lr(A)))


@pytest.mark.parametrize("k,gs", LAYOUTS)
def test_sharded_group_lasso_matches_jax_unsharded(four_ranks, k, gs):
    r = four_ranks
    tag = f"k{k}_gs{gs}"
    back, fixed = _jax_solves(gs)
    assert int(r[f"{tag}_back_status"]) == back.status == 1
    assert (int(r[f"{tag}_back_nit"]), int(r[f"{tag}_back_nit_internal"])) == (back.nit, back.nit_internal)
    np.testing.assert_allclose(r[f"{tag}_back_x"], np.asarray(back.x), rtol=0, atol=1e-10)
    assert int(r[f"{tag}_fixed_status"]) == fixed.status == 1
    assert int(r[f"{tag}_fixed_nit"]) == fixed.nit
    np.testing.assert_allclose(r[f"{tag}_fixed_x"], np.asarray(fixed.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("k,gs", LAYOUTS)
def test_sharded_prox_and_g(four_ranks, k, gs):
    """Aligned blocks: the prox bitwise the unsharded prox, no collective.
    Straddling groups: one all-reduce per prox call, the prox and g within
    rounding of the unsharded ones."""
    flags = four_ranks[f"k{k}_gs{gs}_prox"]  # per rank: bitwise, calls, err, g_err
    assert flags.shape == (k, 4)
    if (k, gs) in ALIGNED:
        assert flags[:, 0].tolist() == [1.0] * k and flags[:, 1].tolist() == [0.0] * k
    else:
        assert flags[:, 1].tolist() == [1.0] * k
        assert float(np.max(flags[:, 2])) <= 1e-15
    assert float(np.max(flags[:, 3])) <= 1e-14


def test_straddling_group_sweep_matches_jax(four_ranks):
    import jax.numpy as jnp

    from zfista_tpu.models.lasso import make_group_lasso_lambda_sweep
    from zfista_tpu.parallel.batch import minimize_proximal_gradient_batch as jbatch

    r = four_ranks
    A, b = _data()
    ref = jbatch(*make_group_lasso_lambda_sweep(A, b, 8), np.zeros((SWEEP_LANES, N)),
                 batch_params=jnp.linspace(0.02, 0.2, SWEEP_LANES), lr=_lr(A), nesterov=True,
                 max_iter=20000)
    assert np.all(np.asarray(ref.success)) and np.all(r["sweep_status"] == 1)
    np.testing.assert_array_equal(r["sweep_nit"], np.asarray(ref.nit))
    np.testing.assert_allclose(r["sweep_x"], np.asarray(ref.x), rtol=0, atol=1e-10)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.port, a.out)
