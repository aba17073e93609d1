"""The port's subproblem duals vs zfista_tpu.core.subproblem, float64 on
the CPU.

* ``solve_small_linear``: against the JAX elimination, and inf/NaN without
  raising on a singular system;
* m=2 bisection: interior optimum and both vertices, exact ``nit``, and
  the static step count (width floor in float32);
* m in {3, 4, 5} semismooth Newton: the dual value matches or beats the
  JAX one and the primal-dual gap certifies it (the certificates of
  tests/test_subproblem_stress.py).

One jitted JAX solver per objective count, reused across instances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.core import subproblem as js
from zfista_tpu.ops import soft_threshold as j_soft
from zfista_tpu_torch.core import subproblem as ts
from zfista_tpu_torch.ops.prox import soft_threshold as t_soft

F64 = torch.float64
TOL = 1e-11  # the benchmark's tol_internal
N = 10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _instance(kind, m, seed):
    """tests/test_subproblem_stress.py's instance families."""
    rng = np.random.RandomState(seed)
    l1 = 0.05 * (1 + np.arange(m))
    shift = np.zeros(N)
    y = rng.randn(N)
    f_y = rng.rand(m)
    F_old = f_y + rng.rand(m)
    lr = 0.5
    if kind == "random":
        J = rng.randn(m, N)
    elif kind == "rank2":
        J = rng.randn(m, 2) @ rng.randn(2, N)
    elif kind == "vertex":
        J = 0.1 * rng.randn(m, N)
        F_old = f_y + 5.0 + rng.rand(m)
        F_old[m // 2] = f_y[m // 2] - 5.0
    elif kind == "edge":
        J = 0.1 * rng.randn(m, N)
        F_old = f_y + 5.0 + rng.rand(m)
        F_old[0] = f_y[0] - 5.0
        F_old[1] = f_y[1] - 5.0
    elif kind == "kink":
        shift = rng.randn(N)
        y = shift.copy()
        J = rng.randn(m, N)
    else:
        raise ValueError(kind)
    return y, J, f_y, F_old, lr, l1, shift


def _callables(l1, shift, dtype=F64):
    l1_j, shift_j = jnp.asarray(l1), jnp.asarray(shift)
    l1_t, shift_t = _t(l1).to(dtype), _t(shift).to(dtype)

    def g_j(x):
        return l1_j * jnp.sum(jnp.abs(x - shift_j))

    def prox_j(wl1, x):
        return shift_j + j_soft(x - shift_j, jnp.sum(wl1 * l1_j))

    def g_t(x):
        return l1_t * torch.sum(torch.abs(x - shift_t))

    def prox_t(wl1, x):
        return shift_t + t_soft(x - shift_t, torch.sum(wl1 * l1_t))

    return (g_j, prox_j), (g_t, prox_t)


@functools.cache
def _jax_solver(m, l1_key, shift_key):
    (g_j, prox_j), _ = _callables(np.array(l1_key), np.array(shift_key))
    solve = js.make_subproblem_solver(g_j, prox_j, m, tol=TOL, max_iter=10000)
    return jax.jit(solve)


def _solve_both(y, J, f_y, F_old, lr, l1, shift, w0=None):
    m = J.shape[0]
    w0 = np.ones(m) / m if w0 is None else w0
    solve_j = _jax_solver(m, tuple(l1), tuple(shift))
    rj = solve_j(*(jnp.asarray(v) for v in (lr, F_old, y, f_y, J, w0)))
    _, (g_t, prox_t) = _callables(l1, shift)
    solve_t = ts.make_subproblem_solver(g_t, prox_t, m, tol=TOL, max_iter=10000)
    rt = solve_t(*(_t(v) for v in (lr, F_old, y, f_y, J, w0)))
    return rj, rt


def _primal_value(x, y, J, f_y, F_old, lr, l1, shift):
    g_x = l1 * np.sum(np.abs(x - shift))
    terms = J @ (x - y) + g_x + f_y - F_old
    return np.max(terms) + np.linalg.norm(x - y) ** 2 / (2 * lr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_small_linear_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (3, 4, 6):
        K = rng.standard_normal((n, n))
        K[0, 0] = 0.0  # forces a pivot swap at the first column
        b = rng.standard_normal(n)
        got = ts.solve_small_linear(_t(K), _t(b)).numpy()
        ref = np.asarray(js.solve_small_linear(jnp.asarray(K), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(K @ got, b, atol=1e-10)


def test_solve_small_linear_singular_is_nonfinite_not_raising():
    K = np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]])
    b = np.array([1.0, 1.0, 1.0])
    got = ts.solve_small_linear(_t(K), _t(b)).numpy()  # no exception
    ref = np.asarray(js.solve_small_linear(jnp.asarray(K), jnp.asarray(b)))
    assert not np.all(np.isfinite(got))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    with pytest.raises(RuntimeError):
        torch.linalg.solve(_t(K), _t(b))  # why the elimination is kept


@pytest.mark.parametrize(
    "where, F_shift",
    [("interior", (0.0, 0.0)), ("vertex0", (0.0, 40.0)), ("vertex1", (40.0, 0.0))],
)
def test_m2_bisection_matches_jax(where, F_shift):
    y, J, f_y, F_old, lr, l1, shift = _instance("random", 2, 7)
    F_old = F_old + np.array(F_shift)
    rj, rt = _solve_both(y, J, f_y, F_old, lr, l1, shift)
    assert int(rt.nit) == int(rj.nit)
    w = rt.weight.numpy()
    if where == "interior":
        assert int(rt.nit) == 2 + ts._bisection_steps(37, TOL, F64) and 0 < w[0] < 1
    else:
        assert int(rt.nit) == 2
        assert w[0] == (1.0 if where == "vertex0" else 0.0)
    np.testing.assert_array_equal(w, np.asarray(rj.weight))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-14)
    np.testing.assert_allclose(float(rt.fun), float(rj.fun), rtol=1e-13, atol=1e-14)
    assert rt.nit.dtype == torch.int32


def test_m2_bisection_step_count_is_static():
    """The JAX loop's width floor, counted in the dtype: 40 halvings at
    tol 1e-12 in float64, 23 in float32 (interval 2**-23 <= 1.2e-7)."""
    assert ts._bisection_steps(40, 1e-12, F64) == 40
    assert ts._bisection_steps(40, 1.2e-7, torch.float32) == 23
    assert ts._bisection_steps(5, 1e-12, F64) == 5
    # float32 solve: nit = 2 + 23 for an interior optimum.
    y, J, f_y, F_old, lr, l1, shift = _instance("random", 2, 7)
    _, (g_t, prox_t) = _callables(l1, shift, torch.float32)
    solve = ts.make_subproblem_solver(g_t, prox_t, 2, tol=1e-12, max_iter=10000)
    f32 = lambda v: torch.tensor(np.asarray(v), dtype=torch.float32)
    r = solve(*(f32(v) for v in (lr, F_old, y, f_y, J, np.ones(2) / 2)))
    assert int(r.nit) == 25 and r.x.dtype == torch.float32


@pytest.mark.parametrize("m", [3, 4, 5])
@pytest.mark.parametrize("kind", ["random", "rank2", "vertex", "edge", "kink"])
def test_mk_newton_matches_or_beats_jax_with_certified_gap(m, kind):
    for trial in range(2):
        inst = _instance(kind, m, 100 * m + trial)
        y, J, f_y, F_old, lr, l1, shift = inst
        rj, rt = _solve_both(*inst)
        ours, ref = float(rt.fun), float(rj.fun)
        ctx = f"m={m} {kind} trial={trial}"
        w = rt.weight.numpy()
        assert np.all(w >= -1e-12) and abs(w.sum() - 1) < 1e-9, ctx
        # Primal value = -dual: at least the JAX value (up to rounding).
        assert ours >= ref - 1e-9 * (1 + abs(ref)), ctx
        primal = _primal_value(rt.x.numpy(), y, J, f_y, F_old, lr, l1, shift)
        gap = primal - ours
        scale = 1.0 + abs(ours)
        assert -1e-9 * scale <= gap <= 1e-7 * scale, f"{ctx}: gap={gap}"
        assert isinstance(rt.nit, int) and rt.nit >= 1 + m + 2


def test_mk_newton_nit_adds_up_like_jax():
    """On a well-conditioned instance the Newton path is the JAX one, so
    the inner count is equal, not just close."""
    inst = _instance("random", 3, 5)
    rj, rt = _solve_both(*inst)
    assert rt.nit == int(rj.nit)
    np.testing.assert_allclose(rt.weight.numpy(), np.asarray(rj.weight), atol=1e-12)
