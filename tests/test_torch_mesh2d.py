"""The port's two-axis ``("batch", "model")`` mesh: lane batches on a
feature-sharded operator, over four real processes on a 2x2 mesh (Gloo on
the CPU, float64), at ``__graft_entry__.dryrun_multichip``'s shapes
(B = 2 * (4 // 2) lanes, m = 16, n = 8 * 2).

Each batch (``Lasso.solve_batch``, both λ-sweep factories, the vmapped
``fista_step_dense``) runs on the 2x2 mesh and on the 1x2 (model-only)
mesh of the rank's batch row; the 2x2 result must be bitwise the 1x2
result, and both are held against the JAX package's unsharded batch of the
same seed-made numpy inputs (JAX x64: equal ``nit`` per lane, x within
1e-10).  The collectives that run under ``torch.func.vmap`` are counted:
one all-reduce per call for all of a rank's lanes, bitwise a per-lane loop.

The four processes run this file (``python tests/test_torch_mesh2d.py
--rank r --world 4 --port p --out dir``); rank 0 writes the results.
"""

from __future__ import annotations

from torch_env import RANKS_TIMEOUT, child_env, run_world
import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zfista_tpu_torch.models import lasso as tl  # noqa: E402
from zfista_tpu_torch.parallel import distributed as td  # noqa: E402
from zfista_tpu_torch.parallel import sharding as ts  # noqa: E402
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch  # noqa: E402
from zfista_tpu_torch.parallel.sharding import P  # noqa: E402

CPU = "cpu"
B, M, N = 4, 16, 16
GROUP = 4
LAM_STEP, LR_STEP, STEPS = 0.1, 1e-3, 50
CASES = ("solve_batch", "lasso_sweep", "group_sweep", "dense_step")
FIELDS = ("x", "nit", "nit_internal", "fun", "lr", "error_criterion", "status")


def _data():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    b = rng.standard_normal(M)
    X0 = rng.uniform(-1.0, 1.0, (B, N))
    return A, b, X0, np.linspace(0.05, 0.5, B), 1.0 / float(2 * np.linalg.norm(A, 2) ** 2)


def _batches(mesh) -> dict:
    """Every case on ``mesh``: the whole batch's per-lane fields."""
    A, b, X0, lams, lr = _data()
    A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
    b_t = torch.as_tensor(b)
    kw = dict(lr=lr, nesterov=True, max_iter=20000)
    out = {}
    r = tl.Lasso(A_g, b_t, 0.05).solve_batch(X0, decay_rate=1, **kw)
    out["solve_batch"] = r
    # The sweeps backtrack from 1/L (decay_rate 0.5): trials, the model
    # value's sums and the l1 / group sums all reduce over "model".
    sweep = tl.make_lasso_lambda_sweep(A_g, b_t, l2_ratio=0.1)
    out["lasso_sweep"] = minimize_proximal_gradient_batch(
        *sweep, np.zeros((B, N)), batch_params=torch.as_tensor(lams),
        in_sharding=ts.batch_sharding(mesh), **kw)
    group = tl.make_group_lasso_lambda_sweep(A_g, b_t, GROUP)
    out["group_sweep"] = minimize_proximal_gradient_batch(
        *group, np.zeros((B, N)), batch_params=torch.as_tensor(lams), **kw)
    lam, lr_t = torch.tensor(LAM_STEP, dtype=torch.float64), torch.tensor(LR_STEP, dtype=torch.float64)
    step = torch.func.vmap(lambda x, y, t: tl.fista_step_dense(A_g, b_t, lam, lr_t, (x, y, t)))
    lanes = ts.NamedSharding(mesh, P("batch", "model"))
    x = td.distribute_global(X0, mesh, P("batch", "model"), device=CPU)
    c = (x, x, torch.ones(x.shape[0], dtype=x.dtype))
    before = ts.collective_counts["sum"]
    for _ in range(STEPS):
        c = step(*c)
    out["dense_step"] = {"x": ts.gather(c[0], lanes).numpy(),
                         "sums": ts.collective_counts["sum"] - before}
    return out


def _flat(res: dict, prefix: str) -> dict:
    flat = {}
    for case, r in res.items():
        if case == "dense_step":
            flat[f"{prefix}_{case}_x"] = r["x"]
            flat[f"{prefix}_{case}_sums"] = r["sums"]
            continue
        for k in FIELDS:
            flat[f"{prefix}_{case}_{k}"] = np.asarray(r[k])
        for k, v in r.state._asdict().items():
            flat[f"{prefix}_{case}_state_{k}"] = v
    return flat


def _worker(rank: int, world: int, port: int, out: Path) -> None:
    torch.set_num_threads(1)
    td.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = ts.make_mesh(batch=2, model=2)
        i, j = mesh.index("batch"), mesh.index("model")
        # One "batch" group (the grid's column) and one "model" group (its
        # row) per rank.
        groups = (dist.get_process_group_ranks(mesh.group("batch")),
                  dist.get_process_group_ranks(mesh.group("model")))
        assert groups == (mesh.devices[:, j].tolist(), mesh.devices[i, :].tolist()), groups
        # Every rank makes both rows' meshes, in one order (new_group).
        rows = [ts.make_mesh(batch=1, model=2, devices=[0, 1]),
                ts.make_mesh(batch=1, model=2, devices=[2, 3])]

        # A (B, n) lane block laid out by lanes and by features.
        X = np.arange(B * N, dtype=np.float64).reshape(B, N)
        two = td.distribute_global(X, mesh, P("batch", "model"), device=CPU)
        assert np.array_equal(two.numpy(), X[2 * i:2 * i + 2, 8 * j:8 * j + 8])
        assert np.array_equal(ts.gather(two, ts.sharding_of(two)).numpy(), X)

        # The collectives under vmap: one all-reduce for every lane, each
        # lane bitwise its own call.
        g = mesh.group("model")
        v = torch.as_tensor(np.random.default_rng(10 + rank).standard_normal((3, 5)))
        v[1, 2] = torch.nan if rank == 1 else v[1, 2]
        vmapped, looped, calls = {}, {}, {}
        for kind, fn in (("sum", ts.all_reduce_sum), ("max", ts.all_reduce_max)):
            before = ts.collective_counts[kind]
            vmapped[kind] = torch.func.vmap(lambda r: fn(r * 1.0, g))(v)
            calls[kind] = ts.collective_counts[kind] - before
            looped[kind] = torch.stack([fn(v[k] * 1.0, g) for k in range(v.shape[0])])
        same = [torch.equal(torch.nan_to_num(vmapped[k]), torch.nan_to_num(looped[k]))
                and torch.equal(vmapped[k].isnan(), looped[k].isnan()) for k in ("sum", "max")]

        # All-reduces per step of a fixed-step sweep on the 2x2 mesh.
        A, b, X0, lams, lr = _data()
        A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
        sweep = tl.make_lasso_lambda_sweep(A_g, torch.as_tensor(b))
        per_step = []
        for iters in (10, 20):
            before = dict(ts.collective_counts)
            minimize_proximal_gradient_batch(
                *sweep, X0, batch_params=torch.as_tensor(lams), lr=lr, decay_rate=1,
                nesterov=True, tol=0, max_iter=iters, keep_state=False)
            per_step.append({k: ts.collective_counts[k] - before[k] for k in before})
        per_step = {k: (per_step[1][k] - per_step[0][k]) / 10 for k in per_step[0]}

        res = _flat(_batches(mesh), "mesh2x2")
        res.update(_flat(_batches(rows[i]), "mesh1x2"))
        if rank == 0:
            np.savez(out / "mesh2d.npz", calls_sum=calls["sum"], calls_max=calls["max"],
                     same=np.array(same), lanes=v.shape[0], nan_max=bool(vmapped["max"][1, 2].isnan()),
                     per_step_sum=per_step["sum"], per_step_max=per_step["max"],
                     per_step_gather=per_step["gather"], **res)
        print(f"MESH2D_OK rank={rank}", flush=True)
    finally:
        td.shutdown()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2d")
    ranks = run_world(
        lambda r, port: [sys.executable, __file__, "--rank", str(r), "--world", "4",
                         "--port", str(port), "--out", str(out)],
        4, cwd=ROOT, timeout=RANKS_TIMEOUT, env=child_env(PYTHONPATH=str(ROOT)),
    )
    for r, (code, text) in enumerate(ranks):
        assert code == 0, f"rank {r} failed:\n{text[-3000:]}"
        assert f"MESH2D_OK rank={r}" in text
    return dict(np.load(out / "mesh2d.npz"))


def test_vmapped_collectives_are_one_all_reduce_bitwise_a_loop(four_ranks):
    r = four_ranks
    assert int(r["calls_sum"]) == 1 and int(r["calls_max"]) == 1 and int(r["lanes"]) == 3
    assert r["same"].tolist() == [True, True]
    assert bool(r["nan_max"])  # NaN on one rank is NaN on the other


def test_one_all_reduce_per_product_for_every_lane(four_ranks):
    r = four_ranks
    # A fixed step: A @ y (one sum for every lane) and max|x - y| (one max).
    assert (float(r["per_step_sum"]), float(r["per_step_max"]), float(r["per_step_gather"])) == (1, 1, 0)
    # The vmapped dense step: A @ y, one sum per step for every lane.
    assert int(r["mesh2x2_dense_step_sums"]) == STEPS


@pytest.mark.parametrize("case", CASES)
def test_two_axis_batch_is_bitwise_the_model_only_batch(four_ranks, case):
    r = four_ranks
    keys = [k[len("mesh2x2_"):] for k in r if k.startswith(f"mesh2x2_{case}_") and not k.endswith("_sums")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r[f"mesh2x2_{k}"], r[f"mesh1x2_{k}"], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_two_axis_batch_matches_jax_unsharded(four_ranks, case):
    import jax
    import jax.numpy as jnp

    from zfista_tpu.models import lasso as jl
    from zfista_tpu.parallel.batch import minimize_proximal_gradient_batch as jbatch

    r = four_ranks
    A, b, X0, lams, lr = _data()
    kw = dict(lr=lr, nesterov=True, max_iter=20000)
    if case == "dense_step":
        lam, lr_s = jnp.asarray(LAM_STEP), jnp.asarray(LR_STEP)

        @jax.jit
        def go(x):
            step = jax.vmap(lambda x, y, t: jl.fista_step_dense(jnp.asarray(A), jnp.asarray(b), lam, lr_s, (x, y, t)))
            c = (x, x, jnp.ones(B))
            return jax.lax.fori_loop(0, STEPS, lambda _, c: step(*c), c)[0]

        np.testing.assert_allclose(r["mesh2x2_dense_step_x"], np.asarray(go(jnp.asarray(X0))), rtol=0, atol=1e-10)
        return
    if case == "solve_batch":
        ref = jl.Lasso(A, b, 0.05).solve_batch(X0, decay_rate=1, **kw)
    elif case == "lasso_sweep":
        ref = jbatch(*jl.make_lasso_lambda_sweep(A, b, l2_ratio=0.1), np.zeros((B, N)),
                     batch_params=jnp.asarray(lams), **kw)
    else:
        ref = jbatch(*jl.make_group_lasso_lambda_sweep(A, b, GROUP), np.zeros((B, N)),
                     batch_params=jnp.asarray(lams), **kw)
    assert np.all(np.asarray(ref.success))
    np.testing.assert_array_equal(r[f"mesh2x2_{case}_nit"], np.asarray(ref.nit))
    np.testing.assert_array_equal(r[f"mesh2x2_{case}_status"], 1)
    np.testing.assert_allclose(r[f"mesh2x2_{case}_x"], np.asarray(ref.x), rtol=0, atol=1e-10)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.port, a.out)
