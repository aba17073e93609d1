"""Whole solves through ``Problem.solve``: the port vs the JAX package,
float64 on the CPU, in the tolerance classes of ROADMAP.md Queue 3.

* m=1 backtracking (LASSO): exact ``nit`` and ``nit_internal``, x at 1e-10;
* m=2 (JOS1 + L1, TOI4, ZDT1): a 12-iteration window at 1e-8, equal status
  and final ``fun``;
* m>=3 (FDS, LinearFunctionRank1): equal ``nit`` and status, x at 1e-6;
* every option of the single solve, one case each; ``return_all``
  histories; ``verbose`` rows; ``check_every``, ``iter_chunk`` and
  ``initial_state`` continuations bitwise equal to the uninterrupted port
  solve; the partial result after a device fault; and the fused LASSO
  kernel kept off the multiobjective and backtracking paths.

JAX problems are module-level so that repeated solves reuse their compiled
programs.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zfista_tpu.models as jm
from zfista_tpu.models import lasso as jl
from zfista_tpu_torch import interop, minimize_proximal_gradient
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.ops.prox import soft_threshold

F64 = torch.float64
TOL_INTERNAL = 1e-11

J_JOS1 = jm.JOS1(n_features=8, l1_ratios=[1 / 8, 2 / 8], l1_shifts=[0.0, -1.0])
J_TOI4 = jm.TOI4(l1_ratios=[0.25, 0.25], l1_shifts=[0.0, 0.0])
J_ZDT1 = jm.ZDT1(n_features=12)
J_FDS = jm.FDS(n_features=6, l1_ratios=[1 / 6] * 3, l1_shifts=[0.0, 1.0, -1.0])
J_LFR1 = jm.LinearFunctionRank1(n_features=8, n_objectives=4)
T = {p.name: interop.problem_from_spec(p) for p in (J_JOS1, J_TOI4, J_ZDT1, J_FDS, J_LFR1)}


def _x0(p, lo, hi, k=0):
    return np.random.default_rng(42).uniform(lo, hi, size=(k + 1, p.n_features))[k]


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


def _both(jp, x0, **kw):
    kw.setdefault("tol_internal", TOL_INTERNAL)
    rj = _quiet(jp.solve, jnp.asarray(x0), **kw)
    rt = _quiet(T[jp.name].solve, torch.tensor(x0), **kw)
    return rj, rt


def _assert_states_equal(a, b, ctx=""):
    for name, u, v in zip(solver.State._fields, a, b):
        assert np.array_equal(u, v) and u.dtype == v.dtype, f"{ctx} State.{name}"


def _lasso(seed, m=30, n=60):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, 4, replace=False)] = rng.standard_normal(4)
    return A, A @ x_true + 0.01 * rng.standard_normal(m)


@pytest.mark.parametrize(
    "seed, opts",
    [(0, dict(nesterov=True)), (1, dict()), (2, dict(nesterov=True, lr=3.0, decay_rate=0.7))],
)
def test_backtracking_lasso_matches_jax(seed, opts):
    A, b = _lasso(seed)
    x0 = np.zeros(A.shape[1])
    rj = jl.Lasso(A, b, 0.05).solve(jnp.asarray(x0), tol=1e-9, **opts)
    rt = tl.Lasso(A, b, 0.05, device="cpu").solve(torch.tensor(x0), tol=1e-9, **opts)
    assert rj.status == 1 and rt.status == 1
    assert (rt.nit, rt.nit_internal) == (rj.nit, rj.nit_internal)
    assert rt.nit_internal > rt.nit  # the line search backtracked
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-12)
    assert rt.lr == float(rj.lr)


@pytest.mark.parametrize(
    "jp, lo, hi",
    [(J_JOS1, -2.0, 4.0), (J_TOI4, -2.0, 5.0), (J_ZDT1, 0.01, 1.0)],
    ids=lambda v: getattr(v, "name", ""),
)
def test_m2_window_and_full_solve_match_jax(jp, lo, hi):
    for k in range(2):
        x0 = _x0(jp, lo, hi, k)
        rj, rt = _both(jp, x0, max_iter=12, tol=0)
        assert (rt.nit, rt.nit_internal) == (rj.nit, rj.nit_internal)
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)
        rj, rt = _both(jp, x0, max_iter=5000)
        assert rt.status == rj.status == 1
        np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("jp", [J_FDS, J_LFR1], ids=lambda p: p.name)
def test_mk_solves_match_jax(jp):
    x0 = _x0(jp, -1.0, 1.0)
    rj, rt = _both(jp, x0, nesterov=True, max_iter=5000)
    assert rt.status == rj.status == 1 and rt.nit == rj.nit
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-8, atol=1e-10)
    # The inner count is the sum of the Newton solves' counts; their stall
    # tests sit at the rounding floor, so it agrees to a few percent.
    assert abs(rt.nit_internal - rj.nit_internal) <= 0.1 * rj.nit_internal


@pytest.mark.parametrize(
    "jp, lo, hi, opts",
    [
        (J_JOS1, -2.0, 4.0, dict(nesterov=True, warm_start=True)),
        (J_JOS1, -2.0, 4.0, dict(nesterov=True, deprecated=True)),
        (J_JOS1, -2.0, 4.0, dict(nesterov=True, nesterov_ratio=(0.5, 0.25))),
        (J_JOS1, -2.0, 4.0, dict(nesterov=True, adaptive_restart=True)),
        (J_ZDT1, 0.01, 1.0, dict(nesterov=True, project_momentum=True)),
        (J_TOI4, -2.0, 5.0, dict(nesterov=True, tol_internal_rel=1e-6)),
        (J_TOI4, -2.0, 5.0, dict(nesterov=True, tol_rel=1e-3)),
        (J_TOI4, -2.0, 5.0, dict(lr=0.3, decay_rate=1)),
        (J_JOS1, -2.0, 4.0, dict(decay_rate=0.8, max_backtrack_iter=3, lr=50.0)),
        (J_ZDT1, 0.01, 1.0, dict(nesterov=True)),  # reference failure
        (J_FDS, -1.0, 1.0, dict(nesterov=True, warm_start=True)),
    ],
    ids=[
        "warm_start", "deprecated", "nesterov_ratio", "adaptive_restart",
        "project_momentum", "tol_internal_rel", "tol_rel", "fixed_step_m2",
        "max_backtrack_iter", "line_search_failure", "warm_start_m3",
    ],
)
def test_options_match_jax(jp, lo, hi, opts):
    x0 = _x0(jp, lo, hi)
    rj, rt = _both(jp, x0, max_iter=3000, **opts)
    assert (rt.status, rt.success, rt.message) == (rj.status, rj.success, rj.message)
    assert rt.nit == rj.nit
    if jp.n_objectives <= 2:
        assert rt.nit_internal == rj.nit_internal
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.weight, np.asarray(rj.weight), rtol=0, atol=1e-8)
    assert rt.lr == pytest.approx(float(rj.lr), rel=1e-12)
    if opts.get("max_backtrack_iter") == 3 or jp is J_ZDT1 and "project_momentum" not in opts:
        # Accelerated unprojected ZDT1 leaves dom(f) and fails the line
        # search, as the reference does; the forced case exhausts its 3
        # trials.  The state freezes at the last accepted point.
        assert rt.status == 2 and not rt.success and bool(rt.state.failed)


def test_return_all_histories_match_jax():
    x0 = _x0(J_JOS1, -2.0, 4.0)
    rj, rt = _both(J_JOS1, x0, nesterov=True, return_all=True, max_iter=200)
    assert len(rt.allvecs) == len(rj.allvecs) == rt.nit + 1
    assert len(rt.allerrs) == len(rj.allerrs) == rt.nit
    np.testing.assert_allclose(np.stack(rt.allvecs), np.stack(rj.allvecs), atol=1e-8)
    np.testing.assert_allclose(np.stack(rt.allfuns), np.stack(rj.allfuns), atol=1e-8)
    np.testing.assert_allclose(np.array(rt.allerrs), np.array(rj.allerrs), atol=1e-8)
    np.testing.assert_array_equal(rt.allvecs[0], x0)
    # The history driver ends where the while driver does, bitwise, and
    # its records are the while driver's iterates.
    tp = T[J_JOS1.name]
    plain = tp.solve(torch.tensor(x0), nesterov=True, tol_internal=TOL_INTERNAL, max_iter=200)
    _assert_states_equal(rt.state, plain.state, "return_all")
    np.testing.assert_array_equal(rt.allvecs[-1], plain.x)
    short = _quiet(tp.solve, torch.tensor(x0), nesterov=True, tol_internal=TOL_INTERNAL,
                   max_iter=7, return_all=True, history_chunk=3)
    np.testing.assert_array_equal(np.stack(short.allvecs), np.stack(rt.allvecs[:8]))


def test_return_all_scalar_objective_and_failed_steps():
    """Scalar f: allfuns are floats.  A failed line search records no
    step (ZDT1, accelerated: the last step fails)."""
    rt = _quiet(
        minimize_proximal_gradient,
        lambda x: torch.sum((x - 1.0) ** 2), lambda x: 0.1 * torch.sum(torch.abs(x)),
        None, lambda w, x: soft_threshold(x, 0.1 * w), np.array([3.0, -2.0]),
        nesterov=True, return_all=True, device="cpu",
    )
    assert rt.status == 1 and all(isinstance(v, float) for v in rt.allfuns)
    assert len(rt.allfuns) == rt.nit + 1
    rj, rz = _both(J_ZDT1, _x0(J_ZDT1, 0.01, 1.0), nesterov=True, return_all=True)
    assert rz.status == rj.status == 2
    assert len(rz.allvecs) == len(rj.allvecs) == rz.nit + 1


def test_verbose_prints_five_columns_like_jax(capsys):
    x0 = _x0(J_TOI4, -2.0, 5.0)
    rj = J_TOI4.solve(jnp.asarray(x0), nesterov=True, verbose=True, tol_internal=TOL_INTERNAL)
    jax_out = capsys.readouterr().out
    rt = T[J_TOI4.name].solve(torch.tensor(x0), nesterov=True, verbose=True,
                              tol_internal=TOL_INTERNAL)
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if re.match(r"^\|\s*\d+\|", line)]
    assert len(rows) == rt.nit == rj.nit
    assert all(len(line.split("|")) == 7 for line in rows)  # five columns
    assert out.splitlines()[0].split() == jax_out.splitlines()[0].split()
    jax_rows = [line for line in jax_out.splitlines() if re.match(r"^\|\s*\d+\|", line)]
    assert rows == jax_rows
    # A masked chunk's frozen steps print nothing.
    T[J_TOI4.name].solve(torch.tensor(x0), nesterov=True, verbose=True,
                         tol_internal=TOL_INTERNAL, check_every=8)
    again = [line for line in capsys.readouterr().out.splitlines() if re.match(r"^\|\s*\d+\|", line)]
    assert again == rows


@pytest.mark.parametrize("jp, lo, hi", [(J_JOS1, -2.0, 4.0), (J_FDS, -1.0, 1.0)],
                         ids=lambda v: getattr(v, "name", ""))
def test_check_every_and_iter_chunk_are_bitwise(jp, lo, hi):
    tp = T[jp.name]
    x0 = torch.tensor(_x0(jp, lo, hi))
    kw = dict(nesterov=True, tol_internal=TOL_INTERNAL, max_iter=60)
    ref = _quiet(tp.solve, x0, **kw)
    for extra in (dict(check_every=8), dict(check_every=3), dict(iter_chunk=5),
                  dict(iter_chunk=7, check_every=4)):
        got = _quiet(tp.solve, x0, **kw, **extra)
        np.testing.assert_array_equal(got.x, ref.x)
        assert (got.nit, got.nit_internal) == (ref.nit, ref.nit_internal)
        _assert_states_equal(got.state, ref.state, str(extra))


def test_initial_state_resumes_bitwise_and_from_jax():
    tp = T[J_JOS1.name]
    x0 = _x0(J_JOS1, -2.0, 4.0)
    kw = dict(nesterov=True, tol_internal=TOL_INTERNAL)
    full = _quiet(tp.solve, torch.tensor(x0), max_iter=40, **kw)
    part = _quiet(tp.solve, torch.tensor(x0), max_iter=15, **kw)
    resumed = _quiet(tp.solve, torch.tensor(x0), max_iter=40, initial_state=part.state, **kw)
    _assert_states_equal(resumed.state, full.state, "resume")
    hist = _quiet(tp.solve, torch.tensor(x0), max_iter=40, initial_state=part.state,
                  return_all=True, **kw)
    np.testing.assert_array_equal(hist.allvecs[0], part.x)  # the resume point
    assert len(hist.allvecs) == 40 - 15 + 1
    # From a JAX state, carried across as numpy: the port continues the
    # JAX trajectory (same iteration count, iterates at 1e-8).
    kw_j = dict(kw, tol_internal=TOL_INTERNAL)
    sj = _quiet(J_JOS1.solve, jnp.asarray(x0), max_iter=15, **kw_j).state
    rj = _quiet(J_JOS1.solve, jnp.asarray(x0), max_iter=40, **kw_j)
    st = interop.state_from_numpy(sj, device="cpu")
    assert st.w.shape == (2,) and st.F_x.shape == (2,)
    rt = _quiet(tp.solve, torch.tensor(x0), max_iter=40, initial_state=st, **kw)
    assert (rt.nit, rt.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-8)


class _Fault(torch.AcceleratorError):
    pass


@pytest.mark.parametrize("where", ["m2_backtracking", "m1_fixed_step"])
def test_device_fault_returns_the_last_good_chunk(where):
    """A device error inside a chunk: the result is the host copy taken
    after the last good chunk, success False, status 2, and nothing is
    called after the fault."""
    if where == "m2_backtracking":
        tp = T[J_JOS1.name]
        f, g, jac, prox = tp.f, tp.g, tp.jac_f, tp.prox_wsum_g
        x0 = torch.tensor(_x0(J_JOS1, -2.0, 4.0))
        kw = dict(nesterov=True, tol_internal=TOL_INTERNAL)
    else:
        A, b = _lasso(3)
        p = tl.Lasso(A, b, 0.05, device="cpu")
        f, g, jac, prox = p.f, p.g, p.jac_f, p.prox_wsum_g
        x0 = torch.zeros(A.shape[1], dtype=F64)
        kw = dict(decay_rate=1, lr=0.1, nesterov=True)
    calls = {"n": 0, "after": 0}

    def jac_faulty(x):
        calls["n"] += 1
        if calls["n"] > 12:
            calls["after"] += 1
            raise _Fault("injected: an illegal memory access was encountered")
        return jac(x)

    with pytest.warns(UserWarning, match="device fault after 10 iterations"):
        res = minimize_proximal_gradient(f, g, jac_faulty, prox, x0, iter_chunk=5,
                                         max_iter=100, **kw)
    assert calls["after"] == 1  # the solve stopped at the fault
    assert (res.success, res.status) == (False, 2)
    assert "device fault" in res.message and "iteration 10" in res.message
    assert res.nit == 10 and bool(res.state.failed)
    ref = _quiet(minimize_proximal_gradient, f, g, jac, prox, x0, max_iter=10, **kw)
    np.testing.assert_array_equal(res.x, ref.x)
    if where == "m1_fixed_step":
        assert np.all(np.isnan(res.state.F_x)) and np.isnan(res.fun)  # F never computed
    else:
        np.testing.assert_array_equal(res.fun, ref.fun)


def test_fused_kernel_stays_off_multiobjective_and_backtracking(monkeypatch):
    def refuse(*args):
        raise AssertionError("the fused wrapper was called")

    monkeypatch.setattr(solver, "fused_prox_momentum", refuse)
    A, b = _lasso(4)
    p = interop.lasso_params_from_numpy(A, b, 0.05, device="cpu")
    fns = (tl._lasso_f_p, tl._lasso_g_p, tl._lasso_jac_p, tl._lasso_prox_p)
    x0 = torch.zeros(A.shape[1], dtype=F64)
    for kw in (dict(decay_rate=0.5), dict(decay_rate=1, lr=0.1, return_all=True),
               dict(decay_rate=1, lr=0.1, adaptive_restart=True)):
        _quiet(minimize_proximal_gradient, *fns, x0, params=p, nesterov=True,
               max_iter=30, **kw)
    # A marked prox with several objectives never takes the fused step.
    marked = lambda w, x: x
    marked._soft_threshold_lam = 0.1
    f2 = lambda x: torch.stack([x @ x, (x - 1) @ (x - 1)])
    _quiet(minimize_proximal_gradient, f2, lambda x: torch.zeros(2, dtype=F64), None,
           marked, x0, nesterov=True, decay_rate=1, lr=0.1, max_iter=5)


def test_solve_runs_on_the_start_point_device_and_validates():
    tp = T[J_TOI4.name]
    res = tp.solve(torch.tensor(_x0(J_TOI4, -2.0, 5.0)), nesterov=True)
    assert res.x.dtype == np.float64 and res.state.x.dtype == np.float64
    bad = [dict(iter_chunk=0), dict(tol_internal_rel=-1.0), dict(return_all=True, history_chunk=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            tp.solve(torch.zeros(4, dtype=F64), **kw)
    with pytest.warns(UserWarning, match="ignored when return_all"):
        tp.solve(torch.zeros(4, dtype=F64), return_all=True, check_every=4)
    with pytest.warns(UserWarning, match="ignored when iter_chunk"):
        tp.solve(torch.zeros(4, dtype=F64), iter_chunk=3, check_every=4)
