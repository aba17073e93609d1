"""The port's batch solver with several objectives: against the JAX
package's batch and against the port's own single solves, float64 on the
CPU, in the tolerance classes of ROADMAP.md Queue 3.

* m=2 (JOS1 with and without L1, bounded and unbounded): exact ``nit`` and
  inner counts against JAX's batch and against the port's single solves;
* m>=3 (FDS with and without L1, TRIDIA): equal ``nit``, x at 1e-9
  against the port's single solves, and x at 1e-6 against JAX;
* the lane-batched ``solve_small_linear`` against the single one, singular
  systems included; ``lane_chunk`` and ``check_every`` on an m>=3 batch;
  ``Problem.solve_batch`` against ``zfista_tpu``'s.

Each JAX batch is solved once per module (a vmapped m>=3 JAX program
takes seconds to compile on the CPU).
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zfista_tpu.models as jm
from zfista_tpu.core.subproblem import solve_small_linear as j_solve_small_linear
from zfista_tpu.parallel import batch as jb
from zfista_tpu_torch.core import subproblem as ts
from zfista_tpu_torch.interop import problem_from_spec
from zfista_tpu_torch.parallel import batch as tb

F64 = torch.float64
TOL_INTERNAL = 1e-11

#: (JAX problem, sampling box, lanes, options)
CASES = {
    "jos1": (jm.JOS1(n_features=5), (-2.0, 4.0), 6, dict(nesterov=True)),
    "jos1_l1_ista": (
        jm.JOS1(n_features=6, l1_ratios=[1 / 6, 2 / 6], l1_shifts=[0.0, -1.0]), (-2.0, 4.0), 5,
        dict(),
    ),
    "jos1_bounded_projected": (
        jm.JOS1(n_features=4, bounds=(-1.0, 3.0)), (-1.0, 3.0), 4,
        dict(nesterov=True, project_momentum=True),
    ),
    "fds": (jm.FDS(n_features=4), (-2.0, 2.0), 4, dict(nesterov=True)),
    "fds_l1": (
        jm.FDS(n_features=4, l1_ratios=[0.25] * 3, l1_shifts=[0.0, 1.0, -1.0]), (-2.0, 2.0), 4,
        dict(nesterov=True),
    ),
    "tridia_fixed_step": (jm.TRIDIA(), (-1.0, 1.0), 5, dict(lr=0.02, decay_rate=1, nesterov=True)),
}


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


def _fns(p):
    return p.f, p.g, p.jac_f, p.prox_wsum_g


def _starts(name):
    jp, (lo, hi), B, _ = CASES[name]
    return np.random.default_rng(42).uniform(lo, hi, size=(B, jp.n_features))


def _opts(name):
    return dict(CASES[name][3], tol_internal=TOL_INTERNAL, max_iter=2000)


@pytest.fixture(scope="module")
def jax_results():
    return {
        name: _quiet(jb.minimize_proximal_gradient_batch, *_fns(jp), jnp.asarray(_starts(name)),
                     **_opts(name))
        for name, (jp, *_rest) in CASES.items()
    }


def _port(name, **extra):
    tp = problem_from_spec(CASES[name][0])
    return _quiet(tb.minimize_proximal_gradient_batch, *_fns(tp), torch.tensor(_starts(name)),
                  **{**_opts(name), **extra})


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_matches_jax_and_single_solves(name, jax_results):
    jp = CASES[name][0]
    m = jp.n_objectives
    rj, rt = jax_results[name], _port(name)
    assert rt.fun.shape == np.asarray(rj.fun).shape == (len(rt.x), m)
    np.testing.assert_array_equal(rt.nit, np.asarray(rj.nit))
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    if m == 2:
        np.testing.assert_array_equal(rt.nit_internal, np.asarray(rj.nit_internal))
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-6)
    tp = problem_from_spec(jp)
    for x0, lane in zip(_starts(name), rt.to_list()):
        single = _quiet(tp.solve, torch.tensor(x0), **_opts(name))
        assert (lane.nit, lane.status) == (single.nit, single.status)
        if m == 2:
            assert lane.nit_internal == single.nit_internal
            np.testing.assert_allclose(lane.x, single.x, rtol=0, atol=1e-10)
        else:
            np.testing.assert_allclose(lane.x, single.x, rtol=0, atol=1e-9)
        np.testing.assert_allclose(lane.fun, single.fun, rtol=1e-9)
        np.testing.assert_allclose(lane.weight, single.weight, rtol=0, atol=1e-6)


#: An m>=3 batch for the chunked drivers: 12 lanes of FDS with L1 at n=4,
#: 25 iterations.  Its f computes (x - k)**4, and the CPU's vectorized pow
#: rounds differently in a kernel's tail of fewer than 16 float64 elements
#: than in its vector body, so the lane chunks (8 lanes, the ragged tail
#: padded to 8) keep every lane out of a tail: 12 x 4 and 8 x 4 elements.
CHUNK_PROBLEM = problem_from_spec(CASES["fds_l1"][0])
CHUNK_X0 = np.random.default_rng(7).uniform(-2.0, 2.0, size=(12, 4))


@functools.lru_cache(maxsize=None)
def _chunk_run(extra=()):
    return _quiet(CHUNK_PROBLEM.solve_batch, torch.tensor(CHUNK_X0), nesterov=True,
                  tol_internal=TOL_INTERNAL, max_iter=25, **dict(extra))


@pytest.mark.parametrize("extra", [(("lane_chunk", 8),), (("check_every", 5),), (("iter_chunk", 7),)])
def test_m3_chunked_drivers_are_bitwise_the_unchunked_batch(extra):
    full, chunked = _chunk_run(), _chunk_run(extra)
    for key in ("x", "fun", "nit", "nit_internal", "status", "weight", "lr"):
        np.testing.assert_array_equal(chunked[key], full[key], err_msg=key)
    for u, v in zip(chunked.state, full.state):
        np.testing.assert_array_equal(u, v)


def test_m2_lane_chunk_with_history_is_the_unchunked_batch():
    tp = problem_from_spec(CASES["jos1"][0])
    x0s = torch.tensor(_starts("jos1"))
    ab = np.column_stack([np.linspace(0.0, 0.8, 6), np.linspace(0.05, 0.25, 6)])
    kw = dict(tol_internal=TOL_INTERNAL, batch_nesterov_ratio=ab, record_vecs=True)
    full = _quiet(tp.solve_batch, x0s, **kw)
    chunked = _quiet(tp.solve_batch, x0s, lane_chunk=4, **kw)
    np.testing.assert_array_equal(chunked.x, full.x)
    np.testing.assert_array_equal(chunked.nit_internal, full.nit_internal)
    np.testing.assert_array_equal(chunked.nesterov_ratio, full.nesterov_ratio)
    for rc, rf in zip(chunked.to_list(), full.to_list()):
        assert rc.nesterov_ratio == rf.nesterov_ratio
        np.testing.assert_array_equal(np.asarray(rc.allfuns), np.asarray(rf.allfuns))
        np.testing.assert_array_equal(np.asarray(rc.allvecs), np.asarray(rf.allvecs))
        np.testing.assert_array_equal(rc.allerrs, rf.allerrs)
    for u, v in zip(chunked.state, full.state):
        np.testing.assert_array_equal(u, v)


def test_m2_history_leads_with_F0_and_matches_jax(jax_results):
    jp = CASES["jos1"][0]
    x0s = _starts("jos1")[:3]
    kw = dict(_opts("jos1"), history=True, history_chunk=8)
    rj = _quiet(jb.minimize_proximal_gradient_batch, *_fns(jp), jnp.asarray(x0s), **kw)
    rt = _quiet(problem_from_spec(jp).solve_batch, torch.tensor(x0s), **kw)
    for lt, lj, x0 in zip(rt.to_list(), rj.to_list(), x0s):
        assert len(lt.allfuns) == len(lj.allfuns) == lt.nit + 1
        np.testing.assert_allclose(lt.allfuns[0], np.asarray(jp.f(x0) + jp.g(x0)), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(lt.allfuns), np.asarray(lj.allfuns), rtol=1e-8)
        np.testing.assert_allclose(lt.allerrs, lj.allerrs, rtol=1e-6, atol=1e-12)


def _systems(rng, n, B):
    K = rng.standard_normal((B, n, n))
    K[1, :, 2] = 0.0  # a zero column: singular
    K[2, 3] = K[2, 0]  # two equal rows: singular
    K[3] = np.diag([1e-300, 2.0, 3.0, 4.0, 5.0])  # tiny pivot
    K[4, 0, 0] = K[4, 1, 0] = 2.0  # a pivot tie
    return K, rng.standard_normal((B, n))


def test_solve_small_linear_batched_equals_the_single_one():
    rng = np.random.default_rng(0)
    K, b = _systems(rng, 5, 8)
    got = ts.solve_small_linear_batched(torch.tensor(K), torch.tensor(b)).numpy()
    for i in range(len(K)):
        one = ts.solve_small_linear(torch.tensor(K[i]), torch.tensor(b[i])).numpy()
        np.testing.assert_array_equal(got[i], one)
        ref = np.asarray(j_solve_small_linear(jnp.asarray(K[i]), jnp.asarray(b[i])))
        np.testing.assert_array_equal(np.isfinite(got[i]), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[i][fin], ref[fin], rtol=1e-12)
    assert not np.isfinite(got[1]).all() and not np.isfinite(got[2]).all()
    np.testing.assert_allclose(got[0], np.linalg.solve(K[0], b[0]), rtol=1e-10)


@pytest.mark.parametrize(
    "jp",
    [
        jm.FDS(n_features=5, l1_ratios=[0.2] * 3),
        jm.TRIDIA(l1_ratios=[0.5] * 3),
        jm.LinearFunctionRank1(n_features=6, n_objectives=4, l1_ratios=[0.1] * 4),
    ],
    ids=lambda p: type(p).__name__,
)
def test_batched_newton_dual_equals_the_single_one(jp):
    """The lane-batched semismooth Newton on each lane's own dual against
    the single solver: the same count and weight on FDS and TRIDIA; on the
    rank-one LinearFunctionRank1, whose dual optimum is not unique and
    whose stall tests sit at the rounding floor, the same optimal value
    and primal point.  Lanes that are not live never iterate."""
    tp = problem_from_spec(jp)
    m, n = jp.n_objectives, jp.n_features
    rng = np.random.default_rng(m)
    B = 6
    ys = torch.tensor(rng.uniform(-1, 1, (B, n)))
    f_y = torch.stack([tp.f(y) for y in ys])
    jac = torch.stack([tp.jac_f(y) for y in ys])
    F_old = f_y + torch.stack([tp.g(y) for y in ys]) + 0.1
    lr = torch.tensor(rng.uniform(0.05, 0.5, B))
    w0 = torch.full((B, m), 1.0 / m, dtype=F64)
    live = torch.tensor([True, True, False, True, True, True])
    batched = ts.make_batch_subproblem_solver(tp.g, tp.prox_wsum_g, m, None, tol=1e-11, max_iter=100)
    got = batched(lr, F_old, ys, f_y, jac, w0, live)
    single = ts.make_subproblem_solver(tp.g, tp.prox_wsum_g, m, tol=1e-11, max_iter=100)
    for i in range(B):
        one = single(lr[i], F_old[i], ys[i], f_y[i], jac[i], w0[i])
        if not live[i]:
            assert int(got.nit[i]) == 1  # never iterated
            np.testing.assert_array_equal(got.weight[i].numpy(), np.full(m, 1.0 / m))
        elif m == 3:
            assert int(got.nit[i]) == one.nit
            np.testing.assert_allclose(got.weight[i].numpy(), one.weight.numpy(), rtol=0, atol=1e-9)
            np.testing.assert_allclose(got.x[i].numpy(), one.x.numpy(), rtol=0, atol=1e-9)
        else:
            np.testing.assert_allclose(float(got.fun[i]), float(one.fun), rtol=1e-9)
            np.testing.assert_allclose(got.x[i].numpy(), one.x.numpy(), rtol=0, atol=1e-6)


def test_problem_solve_batch_matches_zfista_tpu():
    jp = jm.JOS1(n_features=3, l1_ratios=[0.2, 0.1])
    x0s = np.random.default_rng(1).uniform(-2, 4, (4, 3))
    rj = _quiet(jp.solve_batch, jnp.asarray(x0s), nesterov=True, tol_internal=TOL_INTERNAL)
    rt = _quiet(problem_from_spec(jp).solve_batch, torch.tensor(x0s), nesterov=True,
                tol_internal=TOL_INTERNAL)
    np.testing.assert_array_equal(rt.nit, np.asarray(rj.nit))
    np.testing.assert_array_equal(rt.nit_internal, np.asarray(rj.nit_internal))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    # numpy starts go to the card by default, or to device="cpu".
    rn = _quiet(problem_from_spec(jp).solve_batch, x0s, device="cpu", nesterov=True,
                tol_internal=TOL_INTERNAL)
    np.testing.assert_array_equal(rn.x, rt.x)
