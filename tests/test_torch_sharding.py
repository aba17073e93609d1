"""The port's mesh placement (``zfista_tpu_torch.parallel.sharding``): a
world of one in this process, and a world of four real processes over Gloo
on the CPU with a 2x2 ``("batch", "model")`` mesh, held against the JAX
package's unsharded solves (JAX x64 against torch float64) — the design
invariant of ``tests/test_sharding.py``: sharding changes placement, never
results.

The four processes run this file (``python tests/test_torch_sharding.py
--rank r --world 4 --port p --out dir``); each checks what it can alone and
rank 0 writes the sharded results for the test to compare.
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

from zfista_tpu_torch.core import solver  # noqa: E402
from zfista_tpu_torch.models import lasso as tl  # noqa: E402
from zfista_tpu_torch.parallel import distributed as td  # noqa: E402
from zfista_tpu_torch.parallel import sharding as ts  # noqa: E402
from zfista_tpu_torch.parallel.sharding import P  # noqa: E402

F64 = torch.float64
CPU = "cpu"


def _rand_lasso(m=32, n=64, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, 8, replace=False)] = rng.standard_normal(8)
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    return A, b


def _lr(A):
    return 1.0 / float(2 * np.linalg.norm(A, 2) ** 2)


def _dense_loop(step, A, b, lam, lr, x0, n_iter=200):
    c = (x0, x0, torch.ones((), dtype=x0.dtype, device=x0.device))
    for _ in range(n_iter):
        c = step(A, b, lam, lr, c)
    return c[0]


# -- a world of one ----------------------------------------------------------


def test_world_of_one_mesh_and_checks():
    mesh = ts.make_mesh()
    assert mesh.shape == {"batch": 1, "model": 1} and mesh.devices.tolist() == [[0]]
    assert mesh.group("batch") is None and mesh.group("model") is None
    assert (mesh.index("batch"), mesh.index("model")) == (0, 0)
    with pytest.raises(ValueError, match="not divisible by model"):
        ts.make_mesh(model=2)
    with pytest.raises(ValueError, match="needs more than"):
        ts.make_mesh(batch=2, model=1)
    assert ts.make_mesh(batch=1, model=1, devices=[0]).devices.size == 1
    # A spec names each mesh axis at most once; one that names both is a
    # lane batch laid out by lanes and by features.
    for bad in (P("model", "model"), P("rows")):
        with pytest.raises(ValueError, match="at most once"):
            ts.NamedSharding(mesh, bad)
    two = ts.NamedSharding(mesh, P("batch", "model"))
    assert two.named == ((0, "batch"), (1, "model"))
    with pytest.raises(ValueError, match="read .named"):
        two.dim
    assert ts.operator_sharding(mesh) == ts.NamedSharding(mesh, P(None, "model"))
    assert (ts.operator_sharding(mesh).dim, ts.operator_sharding(mesh).axis) == ("model", 1)
    assert (ts.batch_sharding(mesh).dim, ts.feature_sharding(mesh).axis) == ("batch", 0)
    assert td.process_count() == 1 and td.all_processes_allclose(np.ones(3))


def test_distribute_global_single_process_placements():
    """With one process every block is the whole array, tagged with its
    placement, on the device asked for; the numpy data is copied."""
    mesh = td.global_mesh()
    rng = np.random.default_rng(0)
    A, x, lanes = rng.standard_normal((6, 16)), rng.standard_normal(16), rng.standard_normal((8, 16))
    A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
    x_g = td.distribute_global(x, mesh, P("model"), device=CPU)
    b_g = td.distribute_batch(lanes, mesh, device=CPU)
    assert ts.sharding_of(A_g) == ts.operator_sharding(mesh)
    assert ts.sharding_of(x_g) == ts.feature_sharding(mesh)
    assert ts.sharding_of(b_g) == ts.batch_sharding(mesh)
    for got, want in ((A_g, A), (x_g, x), (b_g, lanes)):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ts.gather(got, ts.sharding_of(got)).numpy(), want)
    A[0, 0] = 99.0
    assert A_g[0, 0] != 99.0
    assert ts.sharding_of(ts.shard_batch(lanes, device=CPU)).spec == P("batch")


def test_default_placement_is_the_card():
    """Blocks placed with no device go to the card; without one they raise
    as ``data_device`` does, and so does a CUDA rank: only an explicit
    ``device="cpu"`` gives CPU blocks."""
    mesh = td.global_mesh()
    if torch.cuda.is_available():
        assert ts.rank_device().type == "cuda" and ts.rank_device(CPU) == torch.device(CPU)
        return
    for place in (
        ts.rank_device,
        lambda: td.distribute_global(np.ones((4, 8)), mesh, P(None, "model")),
        lambda: td.distribute_batch(np.ones((4, 8)), mesh),
        lambda: ts.shard_batch(np.ones((4, 8)), mesh),
        lambda: td.initialize("localhost:1", 1, 0, backend="nccl"),
    ):
        with pytest.raises(RuntimeError, match="CUDA device"):
            place()
    assert not dist.is_initialized()


def test_world_of_one_feature_sharded_solve_is_the_unsharded_solve(monkeypatch):
    """A feature-sharded solve on a 1x1 mesh is bitwise the unsharded
    solve, and takes the composed tail: the kernel's first entry
    (``fused_prox_momentum``) once per step, never the one-launch tail."""
    A, b = _rand_lasso(m=24, n=32, seed=1)
    lr = _lr(A)
    calls = {"fused_prox_momentum": 0, "lasso_step_tail": 0}

    def counted(name):
        fn = getattr(solver, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapper

    mesh = td.global_mesh()
    sharded = tl.Lasso(td.distribute_global(A, mesh, P(None, "model"), device=CPU),
                       torch.as_tensor(b), l1_ratio=0.05)
    plain = tl.Lasso(torch.as_tensor(A), torch.as_tensor(b), l1_ratio=0.05)
    for name in calls:
        monkeypatch.setattr(solver, name, counted(name))
    r_sh = sharded.solve_fixed_step(np.zeros(32), lr=lr, max_iter=20000)
    assert calls == {"fused_prox_momentum": r_sh.nit, "lasso_step_tail": 0}
    r = plain.solve_fixed_step(torch.zeros(32, dtype=F64), lr=lr, max_iter=20000)
    assert calls["lasso_step_tail"] > 0
    assert r_sh.success and r_sh.nit == r.nit
    for name, u, v in zip(r.state._fields, r_sh.state, r.state):
        if name not in ("F_x",):
            np.testing.assert_array_equal(u, v, err_msg=name)
    np.testing.assert_array_equal(r_sh.x, r.x)


@pytest.mark.parametrize(
    "cls, kw, opts",
    [
        ("JOS1", dict(n_features=16, l1_ratios=[1 / 16, 1 / 16]),
         dict(decay_rate=1, lr=1.0, nesterov=True, max_iter=20)),
        ("FDS", dict(n_features=16, l1_ratios=[1 / 16] * 3), dict(decay_rate=1, lr=0.1, max_iter=10)),
    ],
)
def test_world_of_one_feature_sharded_multiobjective_is_the_unsharded_solve(cls, kw, opts):
    """JOS1 (m = 2) and FDS (m = 3) built on a 1x1 mesh's feature sharding
    and started from a ``feature_sharding`` block take the feature-sharded
    path (the dual's sums and the Hessian through ``feature_sum``), and are
    bitwise the unsharded solve: the single solve and the batch, every
    field."""
    from zfista_tpu_torch.models import zoo

    mesh = td.global_mesh()
    rng = np.random.default_rng(7)
    x0, X = rng.uniform(-2, 2, 16), rng.uniform(-2, 2, (4, 16))
    sharded = getattr(zoo, cls)(**kw, sharding=ts.feature_sharding(mesh))
    plain = getattr(zoo, cls)(**kw)
    got = sharded.solve(td.distribute_global(x0, mesh, P("model"), device=CPU), **opts)
    want = plain.solve(torch.as_tensor(x0), **opts)
    assert got.nit == want.nit == opts["max_iter"] and got.nit_internal == want.nit_internal
    for name, u, v in zip(want.state._fields, got.state, want.state):
        np.testing.assert_array_equal(u, v, err_msg=name)
    got_b = sharded.solve_batch(torch.as_tensor(X), **opts)
    want_b = plain.solve_batch(torch.as_tensor(X), **opts)
    for k in ("x", "nit", "nit_internal", "fun", "status"):
        np.testing.assert_array_equal(got_b[k], want_b[k], err_msg=k)
    for name, u, v in zip(want_b.state._fields, got_b.state, want_b.state):
        np.testing.assert_array_equal(u, v, err_msg=name)


def test_groups_of_a_feature_sharded_operator_are_not_ported():
    """Once not ported, now run: GroupLasso and a lane batch on a
    feature-sharded operator (a world of one: the unsharded results)."""
    mesh = td.global_mesh()
    A, b = _rand_lasso(m=8, n=16)
    A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
    got = tl.GroupLasso(A_g, b, 0.1, group_size=4).solve(np.zeros(16), nesterov=True)
    want = tl.GroupLasso(torch.as_tensor(A), b, 0.1, group_size=4).solve(np.zeros(16), nesterov=True)
    assert got.nit == want.nit and np.array_equal(got.x, want.x)
    x0s = np.zeros((2, 16))
    got = tl.Lasso(A_g, b, 0.1).solve_batch(x0s, nesterov=True)
    want = tl.Lasso(torch.as_tensor(A), b, 0.1).solve_batch(x0s, nesterov=True)
    assert np.array_equal(got.nit, want.nit) and np.array_equal(got.x, want.x)
    with pytest.raises(ValueError, match="operator_sharding"):
        tl.Lasso(td.distribute_batch(np.ones((4, 8)), mesh, device=CPU), np.ones(4), 0.1)


def test_lanes_on_an_operator_lie_by_features():
    """The one place that decides that lanes are feature blocks: callables
    on a feature-sharded operator (a sweep factory's mark) give
    ``P("batch", "model")`` on its mesh, a lanes-only placement gains the
    features, and any other is left for the batch solver to check."""
    mesh = td.global_mesh()
    A, b = _rand_lasso(m=8, n=16)
    A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
    fns = tl.make_lasso_lambda_sweep(A_g, b, device=CPU)
    op = ts.operator_of(*fns)
    two = ts.NamedSharding(mesh, P("batch", "model"))
    assert op == ts.operator_sharding(mesh)
    assert ts.operator_of(*tl.make_lasso_lambda_sweep(A, b, device=CPU)) is None
    assert ts.lanes_on_operator(op) == two
    assert ts.lanes_on_operator(op, ts.batch_sharding(mesh)) == two
    assert ts.lanes_on_operator(op, two) == two
    for other in (ts.feature_sharding(mesh), "lanes"):
        assert ts.lanes_on_operator(op, other) is other
    from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

    lams = torch.tensor([0.05, 0.1], dtype=F64)
    kw = dict(batch_params=lams, nesterov=True, max_iter=50, device=CPU)
    got = minimize_proximal_gradient_batch(*fns, np.zeros((2, 16)), **kw)
    want = minimize_proximal_gradient_batch(
        *tl.make_lasso_lambda_sweep(A, b, device=CPU), np.zeros((2, 16)), **kw
    )
    assert np.array_equal(got.nit, want.nit) and np.array_equal(got.x, want.x)
    with pytest.raises(ValueError, match="places lanes over the 'batch' axis"):
        minimize_proximal_gradient_batch(*fns, np.zeros((2, 16)), in_sharding=ts.feature_sharding(mesh), **kw)


# -- four processes, a 2x2 mesh ------------------------------------------------


def _worker(rank: int, world: int, port: int, out: Path) -> None:
    torch.set_num_threads(1)
    td.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        # initialize is idempotent, and refuses other arguments.
        td.initialize(f"localhost:{port}", world, rank, backend="gloo")
        try:
            td.initialize(f"localhost:{port}", world, rank)
        except RuntimeError as e:
            assert "already initialized" in str(e), e
        else:
            raise AssertionError("initialize with other arguments did not raise")
        assert td.process_count() == world
        # Mesh shapes and checks over the world.
        mesh = ts.make_mesh(batch=2, model=2)
        assert mesh.shape == {"batch": 2, "model": 2}
        assert ts.make_mesh(model=2).shape == {"batch": 2, "model": 2}
        assert ts.make_mesh(batch=1, model=4).shape == {"batch": 1, "model": 4}
        for kw, match in ((dict(batch=1, model=2), "uses only"), (dict(batch=3, model=2), "needs more than"),
                          (dict(model=3), "not divisible")):
            try:
                ts.make_mesh(**kw)
            except ValueError as e:
                assert match in str(e), e
            else:
                raise AssertionError(f"make_mesh({kw}) did not raise")
        sub = ts.make_mesh(batch=1, model=2, devices=[0, 1])
        assert sub.devices.size == 2
        i, j = mesh.index("batch"), mesh.index("model")
        assert mesh.devices[i, j] == rank

        # Placements and contents on the 2x2 mesh.
        rng = np.random.default_rng(0)
        A, x, lanes = rng.standard_normal((6, 16)), rng.standard_normal(16), rng.standard_normal((8, 16))
        A_g = td.distribute_global(A, mesh, P(None, "model"), device=CPU)
        x_g = td.distribute_global(x, mesh, P("model"), device=CPU)
        b_g = td.distribute_batch(lanes, mesh, device=CPU)
        np.testing.assert_array_equal(A_g.numpy(), A[:, 8 * j : 8 * (j + 1)])
        np.testing.assert_array_equal(x_g.numpy(), x[8 * j : 8 * (j + 1)])
        np.testing.assert_array_equal(b_g.numpy(), lanes[4 * i : 4 * (i + 1)])
        for got, want in ((A_g, A), (x_g, x), (b_g, lanes)):
            np.testing.assert_array_equal(ts.gather(got, ts.sharding_of(got)).numpy(), want)
        try:
            td.distribute_global(np.zeros(7), mesh, P("model"), device=CPU)
        except ValueError as e:
            assert "does not divide" in str(e)
        else:
            raise AssertionError("an odd length split over two ranks")

        # With no device named a block goes to the card; here there is none.
        if not torch.cuda.is_available():
            try:
                td.distribute_global(A, mesh, P(None, "model"))
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("a block placed without a card did not raise")

        # The NaN-carrying max: NaN on one rank is NaN on every rank, and
        # no NaN is the plain max.
        v = torch.tensor([float(rank), -float(rank)], dtype=F64)
        got = ts.all_reduce_max(torch.where(torch.tensor(rank == 3), torch.nan, v), dist.group.WORLD)
        assert torch.isnan(got).all(), got
        got = ts.all_reduce_max(v, dist.group.WORLD)
        assert got.tolist() == [float(world - 1), 0.0], got

        # 1. The raw dense step, feature-sharded over "model" (2x2 mesh).
        A1, b1 = _rand_lasso()
        lam, lr = torch.tensor(0.01, dtype=F64), torch.tensor(_lr(A1), dtype=F64)
        A1_g = td.distribute_global(A1, mesh, P(None, "model"), device=CPU)
        x0_g = td.distribute_global(np.zeros(64), mesh, P("model"), device=CPU)
        from zfista_tpu_torch.ops.fused import fista_step_dense_fused

        x_plain = _dense_loop(tl.fista_step_dense, A1_g, torch.as_tensor(b1), lam, lr, x0_g)
        x_fused = _dense_loop(fista_step_dense_fused, A1_g, torch.as_tensor(b1), lam, lr, x0_g)
        assert torch.equal(x_plain, x_fused)
        x_dense = ts.gather(x_plain, ts.feature_sharding(mesh)).numpy()

        # 2. The full solver, features over 4 ranks.
        mesh_tp = ts.make_mesh(batch=1, model=4)
        A2, b2 = _rand_lasso(m=24, n=32, seed=1)
        prob = tl.Lasso(td.distribute_global(A2, mesh_tp, P(None, "model"), device=CPU),
                        torch.as_tensor(b2), l1_ratio=0.01)
        r2 = prob.minimize_proximal_gradient(
            td.distribute_global(np.zeros(32), mesh_tp, P("model"), device=CPU),
            lr=_lr(A2), decay_rate=1, nesterov=True,
        )
        assert r2.success and td.all_processes_allclose(r2.x, atol=0, rtol=0)
        r2f = prob.solve_fixed_step(np.zeros(32), lr=_lr(A2))
        assert td.all_processes_allclose(r2f.x, atol=0, rtol=0)
        # A resume from the result's (whole) state, one block per rank.
        half = prob.solve_fixed_step(np.zeros(32), lr=_lr(A2), max_iter=7)
        rest = prob.solve_fixed_step(np.zeros(32), lr=_lr(A2), initial_state=half.state)
        assert rest.nit == r2f.nit and np.array_equal(rest.x, r2f.x)
        lipschitz = prob.lipschitz()

        # 3. A NaN-carrying state: stops on the same step (max_iter, never
        #    converged) with the same err as unsharded.
        state = half.state._replace(x=half.state.x.copy())
        state.x[29] = np.nan  # rank 3's block
        r_nan = prob.solve_fixed_step(np.zeros(32), lr=_lr(A2), initial_state=state, max_iter=12)
        r_nan_rel = prob.solve_fixed_step(np.zeros(32), lr=_lr(A2), initial_state=state,
                                          max_iter=12, tol_rel=1e-3)

        # 4. A λ sweep over the batch axis of the 2x2 mesh: the two model
        #    ranks of a batch row solve the same lanes.
        f, g, jac_f, prox = tl.make_lasso_lambda_sweep(A2, b2, device=CPU)
        lams = np.linspace(0.05, 0.5, 8)
        from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch

        kw = dict(lr=_lr(A2), nesterov=True, max_iter=20000, batch_params=lams, device=CPU)
        sw = minimize_proximal_gradient_batch(f, g, jac_f, prox, np.zeros((8, 32)),
                                              in_sharding=ts.batch_sharding(mesh), **kw)
        one = minimize_proximal_gradient_batch(f, g, jac_f, prox, np.zeros((8, 32)), **kw)
        np.testing.assert_array_equal(sw.x, one.x)
        np.testing.assert_array_equal(sw.nit, one.nit)
        for u, v in zip(sw.state, one.state):
            np.testing.assert_array_equal(u, v)
        if rank == 0:
            np.savez(
                out / "sharded.npz", x_dense=x_dense, A1=A1, b1=b1, x2=r2.x, nit2=r2.nit,
                x2f=r2f.x, nit2f=r2f.nit, A2=A2, b2=b2, L=lipschitz,
                nan_nit=r_nan.nit, nan_err=r_nan.error_criterion,
                nan_rel_nit=r_nan_rel.nit, nan_rel_err=r_nan_rel.error_criterion,
                **{f"nan_state_{k}": v for k, v in state._asdict().items()},
            )
        print(f"MESH_OK rank={rank}", flush=True)
    finally:
        td.shutdown()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    ranks = run_world(
        lambda r, port: [sys.executable, __file__, "--rank", str(r), "--world", "4",
                         "--port", str(port), "--out", str(out)],
        4, cwd=ROOT, timeout=RANKS_TIMEOUT, env=child_env(PYTHONPATH=str(ROOT)),
    )
    for r, (code, text) in enumerate(ranks):
        assert code == 0, f"rank {r} failed:\n{text[-3000:]}"
        assert f"MESH_OK rank={r}" in text
    return dict(np.load(out / "sharded.npz"))


def test_feature_sharded_dense_loop_matches_jax(four_ranks):
    import jax
    import jax.numpy as jnp

    from zfista_tpu.models.lasso import fista_step_dense

    r = four_ranks
    A, b = jnp.asarray(r["A1"]), jnp.asarray(r["b1"])
    lam, lr = jnp.asarray(0.01), jnp.asarray(_lr(r["A1"]))

    @jax.jit
    def go(c):
        return jax.lax.fori_loop(0, 200, lambda _, c: fista_step_dense(A, b, lam, lr, c), c)

    x0 = jnp.zeros(64)
    ref = np.asarray(go((x0, x0, jnp.ones(())))[0])
    np.testing.assert_allclose(r["x_dense"], ref, rtol=0, atol=1e-10)


def test_feature_sharded_solver_matches_jax(four_ranks):
    from zfista_tpu.models.lasso import Lasso

    r = four_ranks
    prob = Lasso(r["A2"], r["b2"], l1_ratio=0.01)
    ref = prob.minimize_proximal_gradient(np.zeros(32), lr=_lr(r["A2"]), decay_rate=1, nesterov=True)
    assert ref.success and int(r["nit2"]) == ref.nit
    np.testing.assert_allclose(r["x2"], ref.x, rtol=0, atol=1e-10)
    fixed = prob.solve_fixed_step(np.zeros(32), lr=_lr(r["A2"]))
    assert int(r["nit2f"]) == fixed.nit
    np.testing.assert_allclose(r["x2f"], fixed.x, rtol=0, atol=1e-10)
    # The sharded power iteration is the unsharded one to rounding.
    L = tl.Lasso(torch.as_tensor(r["A2"]), torch.as_tensor(r["b2"]), 0.01).lipschitz()
    assert float(r["L"]) == pytest.approx(L, rel=1e-12)


def test_nan_state_stops_as_unsharded(four_ranks):
    r = four_ranks
    prob = tl.Lasso(torch.as_tensor(r["A2"]), torch.as_tensor(r["b2"]), l1_ratio=0.01)
    state = solver.State(*(r[f"nan_state_{k}"] for k in solver.State._fields))
    assert np.isnan(state.x).sum() == 1
    for kw, nit, err in ((dict(), "nan_nit", "nan_err"), (dict(tol_rel=1e-3), "nan_rel_nit", "nan_rel_err")):
        ref = prob.solve_fixed_step(np.zeros(32), lr=_lr(r["A2"]), initial_state=state, max_iter=12, **kw)
        assert ref.status == 0 and int(r[nit]) == ref.nit == 12
        assert np.isnan(ref.error_criterion) and np.isnan(r[err])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.port, a.out)
