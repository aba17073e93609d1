"""Feature-sharded solves with two or more objectives: the port's zoo
problems built with ``sharding=feature_sharding(mesh)`` on 2 and 4 Gloo
processes on the CPU, held against the JAX package (JAX x64 on two of
conftest's virtual CPU devices, ``x0`` placed by its ``feature_sharding``;
torch float64) in the classes of ROADMAP.md Queue 3:

* m = 2 (JOS1 with ℓ1, fixed step and backtracking; ZDT1 with its box):
  equal ``nit``, ``x`` within 1e-8;
* m >= 3 (FDS with ℓ1, fixed step; LinearFunctionRank1 at m = 4): equal
  ``nit``, ``x`` within 1e-6;
* the batch on a 2x2 and a 1x2 mesh (JOS1 and FDS): per lane in those
  classes against the JAX batch, and 2x2 bitwise the 1x2 batch.

Every rank returns the same ``x``, bitwise.  In this process, two threads
stand in for two ranks (:class:`TwoThreads`) to hold the blocks' callables
and the m >= 3 dual's Hessian (``subproblem.dual_hessian``) against the
whole ones.

The processes run this file (``python tests/test_torch_sharded_multi.py
--rank r --world w --port p --out dir``); rank 0 writes the results.  Each
joins its process group with a timeout, and the test waits for each with a
timeout, so a rank that decides alone fails the test instead of hanging it.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zfista_tpu_torch.core import subproblem as sp  # noqa: E402
from zfista_tpu_torch.models import zoo  # noqa: E402
from zfista_tpu_torch.parallel import distributed as td  # noqa: E402
from zfista_tpu_torch.parallel import sharding as ts  # noqa: E402
from zfista_tpu_torch.parallel.sharding import P  # noqa: E402

N = 32
CPU = "cpu"
#: Seconds a collective waits for the other ranks, and the test for a rank.
GLOO_TIMEOUT, RANK_TIMEOUT = 120, 300
#: name: (zoo class, constructor keywords, x0 box, solve options).
CASES = {
    "jos1_fixed": ("JOS1", dict(n_features=N, l1_ratios=[1 / N, 1 / N]), (-2.0, 4.0),
                   dict(decay_rate=1, lr=1.0, nesterov=True, max_iter=20)),
    "jos1_backtracking": ("JOS1", dict(n_features=N, l1_ratios=[0.1, 0.1], l1_shifts=[0.0, 1.0]),
                          (-2.0, 4.0), dict(nesterov=True, max_iter=20)),
    "zdt1": ("ZDT1", dict(n_features=N), (0.01, 1.0), dict(max_iter=20)),
    "fds_fixed": ("FDS", dict(n_features=N, l1_ratios=[1 / N] * 3), (-2.0, 2.0),
                  dict(decay_rate=1, lr=0.1, max_iter=15)),
    "lfr1": ("LinearFunctionRank1", dict(n_features=N, n_objectives=4), (-1.0, 1.0),
             dict(max_iter=15)),
}
#: The batch cases and their lanes.
BATCHES, LANES = ("jos1_fixed", "fds_fixed"), 4
#: m: the x tolerance of the class (equal nit in every class).
XTOL = {2: 1e-8, 3: 1e-6, 4: 1e-6}


def _x0(name: str, lanes: int | None = None) -> np.ndarray:
    lo, hi = CASES[name][2]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return rng.uniform(lo, hi, N if lanes is None else (lanes, N))


def _port(name: str, sharding=None):
    cls, kw, _, _ = CASES[name]
    return getattr(zoo, cls)(**kw, sharding=sharding)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


# -- the ranks ---------------------------------------------------------------


def _counts(fn) -> dict[str, int]:
    before = dict(ts.collective_counts)
    fn()
    return {k: ts.collective_counts[k] - before[k] for k in before}


def _per_call_counts(mesh) -> dict[str, int]:
    """All-reduces of one m = 2 ``psi`` (JOS1 with ℓ1) and of one m >= 3
    Newton iteration (FDS with ℓ1), on a rank's blocks."""
    out = {}
    for name, key in (("jos1_fixed", "psi"), ("fds_fixed", "newton_iteration")):
        prob = _port(name, ts.feature_sharding(mesh))
        y = ts.block(torch.as_tensor(_x0(name)), prob.sharding)
        f_y, J = prob.f(y), prob.jac_f(y)
        lr = torch.tensor(0.1, dtype=torch.float64)
        fsum = lambda v: ts.all_reduce_sum(v, prob.sharding.group)  # noqa: E731
        if key == "psi":
            dual = sp._make_dual(f_y, J, f_y, prob.g, prob.prox_wsum_g, lr, y, False, fsum)
            w = torch.tensor([0.5, 0.5], dtype=torch.float64)
            out[key] = _counts(lambda: dual.grad(w))["sum"]
        else:
            parts = sp.make_newton(prob.g, prob.prox_wsum_g, 3, tol=1e-12, max_iter=100,
                                   feature_sum=fsum)
            c = parts.start(lr, f_y, y, f_y, J, torch.ones(3, dtype=torch.float64) / 3)
            out[key] = _counts(lambda: parts.iterate(c, lr, f_y, y, f_y, J))["sum"]
    return out


def _solves(mesh) -> dict:
    """Every case's single solve on ``mesh``'s feature blocks."""
    out = {}
    for name, (_, _, _, opts) in CASES.items():
        prob = _port(name, ts.feature_sharding(mesh))
        res = _quiet(prob.solve, _x0(name), device=CPU, **opts)
        out[f"{name}.x"], out[f"{name}.nit"], out[f"{name}.status"] = res.x, res.nit, res.status
        out[f"{name}.same"] = td.all_processes_allclose(res.x, atol=0, rtol=0)
    return out


def _batches(mesh, tag: str) -> dict:
    out = {}
    for name in BATCHES:
        prob = _port(name, ts.feature_sharding(mesh))
        res = _quiet(prob.solve_batch, _x0(name, LANES), device=CPU, **CASES[name][3])
        for k in ("x", "nit", "nit_internal", "fun", "status"):
            out[f"{tag}.{name}.{k}"] = np.asarray(res[k])
        for k, v in res.state._asdict().items():
            out[f"{tag}.{name}.state.{k}"] = v
        out[f"{tag}.{name}.same"] = td.all_processes_allclose(res.x, atol=0, rtol=0)
    return out


def _worker(rank: int, world: int, port: int, out: Path) -> None:
    torch.set_num_threads(1)
    td.initialize(f"localhost:{port}", world, rank, backend="gloo", timeout=GLOO_TIMEOUT)
    try:
        res = _solves(ts.make_mesh(batch=1, model=world))
        if world == 2:
            res.update({f"count.{k}": v for k, v in _per_call_counts(ts.make_mesh(batch=1, model=2)).items()})
        else:
            mesh = ts.make_mesh(batch=2, model=2)
            # Every rank makes both rows' meshes, in one order (new_group).
            rows = [ts.make_mesh(batch=1, model=2, devices=[0, 1]),
                    ts.make_mesh(batch=1, model=2, devices=[2, 3])]
            res.update(_batches(mesh, "mesh2x2"))
            res.update(_batches(rows[mesh.index("batch")], "mesh1x2"))
        if rank == 0:
            np.savez(out / f"world{world}.npz", **res)
        print(f"SHARDED_MULTI_OK rank={rank}", flush=True)
    finally:
        td.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world: int, out: Path) -> dict:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", str(world), "--port", str(port),
             "--out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{text[-3000:]}"
        assert f"SHARDED_MULTI_OK rank={r}" in text
    return dict(np.load(out / f"world{world}.npz"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_multi")
    return {w: _run_world(w, out) for w in (2, 4)}


# -- the JAX references --------------------------------------------------------

_JAX: dict = {}


def _jax_devices(k: int):
    import jax

    return jax.devices()[:k]


def _jax_problem(name: str):
    import zfista_tpu.models as jm

    cls, kw, _, _ = CASES[name]
    return getattr(jm, cls)(**kw)


def _jax_solve(name: str):
    """The JAX solve from ``x0`` placed by its ``feature_sharding`` on two
    devices."""
    if name not in _JAX:
        import jax

        from zfista_tpu.parallel.sharding import feature_sharding, make_mesh

        mesh = make_mesh(1, 2, devices=_jax_devices(2))
        x0 = jax.device_put(_x0(name), feature_sharding(mesh))
        _JAX[name] = _quiet(_jax_problem(name).solve, x0, **CASES[name][3])
    return _JAX[name]


def _jax_batch(name: str):
    key = ("batch", name)
    if key not in _JAX:
        from zfista_tpu.parallel.sharding import NamedSharding, make_mesh
        from zfista_tpu.parallel.sharding import P as JP

        mesh = make_mesh(2, 2, devices=_jax_devices(4))
        _JAX[key] = _quiet(
            _jax_problem(name).solve_batch, _x0(name, LANES),
            in_sharding=NamedSharding(mesh, JP("batch", "model")), **CASES[name][3],
        )
    return _JAX[key]


# -- tests -----------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_solve_matches_jax(worlds, world, name):
    got, ref = worlds[world], _jax_solve(name)
    m = _port(name).n_objectives
    assert bool(got[f"{name}.same"]), "the ranks returned different x"
    assert int(got[f"{name}.nit"]) == ref.nit and int(got[f"{name}.status"]) == ref.status
    np.testing.assert_allclose(got[f"{name}.x"], np.asarray(ref.x), rtol=0, atol=XTOL[m])


@pytest.mark.parametrize("mesh", ["mesh2x2", "mesh1x2"])
@pytest.mark.parametrize("name", BATCHES)
def test_sharded_batch_matches_jax(worlds, mesh, name):
    got, ref = worlds[4], _jax_batch(name)
    m = _port(name).n_objectives
    assert bool(got[f"{mesh}.{name}.same"]), "the ranks returned different x"
    np.testing.assert_array_equal(got[f"{mesh}.{name}.nit"], np.asarray(ref.nit))
    np.testing.assert_array_equal(got[f"{mesh}.{name}.status"], np.asarray(ref.status))
    np.testing.assert_allclose(got[f"{mesh}.{name}.x"], np.asarray(ref.x), rtol=0, atol=XTOL[m])


@pytest.mark.parametrize("name", BATCHES)
def test_batch_2x2_is_1x2_bitwise(worlds, name):
    """A lane's bits do not depend on the lanes or ranks beside it: two
    lanes a rank on the 2x2 mesh against four on a 1x2 row, every field."""
    got = worlds[4]
    keys = [k[len("mesh2x2."):] for k in got if k.startswith(f"mesh2x2.{name}.") and not k.endswith(".same")]
    assert len(keys) == 5 + 12
    for k in keys:
        np.testing.assert_array_equal(got[f"mesh2x2.{k}"], got[f"mesh1x2.{k}"], err_msg=k)


def test_all_reduces_per_psi_and_per_newton_iteration(worlds):
    """One m = 2 ``psi`` costs two all-reduces (``g``'s and the product's),
    one m >= 3 Newton iteration eight (the scale; ``g``'s and the dual's in
    ``value_and_grad``; the two ``jacrev`` runs forward and the Hessian's;
    ``g``'s and the value's over the 80 arc trials at once)."""
    got = worlds[2]
    assert int(got["count.psi"]) == 2
    assert int(got["count.newton_iteration"]) == 8


@pytest.mark.parametrize("cls", ["SD", "TOI4", "TRIDIA"])
def test_fixed_size_problems_refuse_a_sharding(cls):
    with pytest.raises(ValueError, match="fixed size"):
        getattr(zoo, cls)(sharding=ts.feature_sharding(ts.make_mesh()))


# -- two threads as two ranks ---------------------------------------------------


class _Mesh:
    """The two ranks' ``"model"`` axis, as ``Problem`` reads a mesh."""

    GROUP = object()

    def __init__(self, rank: int) -> None:
        self.rank = rank

    def group(self, dim: str):
        return self.GROUP

    def size(self, dim: str) -> int:
        return 2 if dim == "model" else 1

    def index(self, dim: str) -> int:
        return self.rank if dim == "model" else 0


class TwoThreads:
    """All-reduces between two threads of this process, each a rank of
    :class:`_Mesh`: both put their operand, both combine the two in rank
    order (a sum, or a max that carries NaN).  A thread that reduces alone
    times out."""

    def __init__(self) -> None:
        self.barrier = threading.Barrier(2, timeout=60)
        self.slots: list = [None, None]
        self.local = threading.local()

    def reduce_now(self, t: torch.Tensor, combine) -> torch.Tensor:
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        out = combine(self.slots[0], self.slots[1])
        self.barrier.wait()
        return out

    def run(self, fn) -> list:
        """``fn(rank)`` on both threads; their results by rank."""
        out: list = [None, None]
        errors: list = []

        def one(rank: int) -> None:
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except Exception as e:  # re-raised in the test's thread below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a rank's thread did not finish"
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def two_threads(monkeypatch):
    fake = TwoThreads()
    for name, combine in (("_sum_now", torch.add), ("_max_now", torch.maximum)):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda t, group, real=real, combine=combine: (
            fake.reduce_now(t, combine) if group is _Mesh.GROUP else real(t, group)))
    return fake


def _block_problem(name: str, rank: int):
    return _port(name, ts.NamedSharding(_Mesh(rank), P("model")))


@pytest.mark.parametrize("name", ["jos1_backtracking", "zdt1", "fds_fixed", "lfr1"])
def test_block_callables_are_the_whole_ones(two_threads, name):
    """``f``, ``jac_f`` and ``g`` of the two blocks against the whole
    problem's: the reduced values on both ranks, the Jacobian's columns of
    each block; ``g`` of a point outside ZDT1's box is inf on both."""
    whole = _port(name)
    x = torch.as_tensor(_x0(name))

    def on_rank(r):
        p = _block_problem(name, r)
        xb = ts.block(x, p.sharding)
        outside = xb.clone()
        outside[-1] = -1.0 if r == 1 else outside[-1]
        return p.f(xb), p.jac_f(xb), p.g(xb), p.g(outside)

    got = two_threads.run(on_rank)
    outside = x.clone()
    outside[-1] = -1.0
    for r, (f, J, g, g_out) in enumerate(got):
        torch.testing.assert_close(f, whole.f(x), rtol=1e-14, atol=0)
        torch.testing.assert_close(J, whole.jac_f(x)[:, r * N // 2 : (r + 1) * N // 2], rtol=1e-14, atol=0)
        torch.testing.assert_close(g, whole.g(x), rtol=1e-14, atol=0)
        torch.testing.assert_close(g_out, whole.g(outside), rtol=1e-14, atol=0)
    assert all(torch.equal(u, v) for u, v in zip(got[0][:1] + got[0][2:], got[1][:1] + got[1][2:]))


@pytest.mark.parametrize("name", ["fds_fixed", "lfr1"])
def test_two_ranks_hessian_is_the_unsharded_hessian(two_threads, name):
    """The m >= 3 dual's Hessian on two ranks' blocks (``dual_hessian``:
    ``jacrev`` through the all-reduces, then one all-reduce of the shares)
    is the unsharded Hessian to 1e-12 of its scale, the same bits on both
    ranks; one rank's share alone (a local-only Hessian) is not."""
    whole = _port(name)
    m = whole.n_objectives
    y = torch.as_tensor(_x0(name))
    f_y, J = whole.f(y), whole.jac_f(y)
    F_old = f_y + whole.g(y) + 0.1
    lr = torch.tensor(0.05, dtype=torch.float64)
    w = torch.as_tensor(np.linspace(1.0, 2.0, m) / np.linspace(1.0, 2.0, m).sum())
    H = sp.dual_hessian(sp._make_dual(f_y, J, F_old, whole.g, whole.prox_wsum_g, lr, y, False).grad, w)

    def on_rank(r):
        p = _block_problem(name, r)
        fsum = lambda v: ts.all_reduce_sum(v, _Mesh.GROUP)  # noqa: E731
        cols = slice(r * N // 2, (r + 1) * N // 2)
        dual = sp._make_dual(f_y, J[:, cols], F_old, p.g, p.prox_wsum_g, lr, y[cols], False, fsum)
        return sp.dual_hessian(dual.grad, w, fsum), torch.func.jacrev(dual.grad)(w)

    (H0, share0), (H1, share1) = two_threads.run(on_rank)
    scale = float(H.abs().max())
    assert torch.equal(H0, H1)
    torch.testing.assert_close(H0, H, rtol=0, atol=1e-12 * scale)
    for share in (share0, share1):
        assert float((share - H).abs().max()) > 1e-3 * scale


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.port, a.out)
