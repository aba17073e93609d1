"""The m >= 3 Newton subproblem on the device: the single solve, the
batch's carried search and the history drivers as replayed CUDA graphs,
on the CPU.

With the stand-in graph of tests/test_torch_graph.py (its "capture" runs
the chunk and restores the static buffers, its replay runs the chunk with
the launch counters held) and graphs allowed on the CPU:

* (a) ``subproblem.arc_searches``, both Armijo arcs with their 40 trials
  on one trial axis, against the sequential JAX arc search at one point:
  the same accepted ``w``, ``phi`` and count, bit for bit, for a Newton
  arc accepted at its first trial and after halvings, a retry along the
  projected gradient, no trial accepted (40 and 80 trials) and the
  ``bad`` skip (the retry not taken, its trials not counted); and one
  Newton iteration of a real dual the same at any lane count;
* (b) the single solve's carried Newton steps (``carried_search``, one
  Newton iteration of the current trial a step) on the graphed driver at
  chunks of 1, 3 and 8, and the public solve at ``check_every`` 3 and 8,
  every State field, ``nit`` and ``nit_internal`` bitwise the
  ``check_every=1`` solve: FDS (m = 3), FDS with its l1 terms, box-bounded
  FDS, TRIDIA with l1 and LinearFunctionRank1 (m = 4), by backtracking and
  by the fixed step, with ``warm_start`` and at ``max_iter_internal`` 0
  and 1;
* (c) the batch's per-lane carried Newton steps at ``check_every=8``,
  every lane bitwise the round-based ``check_every=1`` batch, for lanes
  whose Newton counts differ, for a lane that fails at
  ``max_backtrack_iter=3`` beside converging lanes, and under
  ``lane_chunk``;
* (d) ``return_all`` and the batch history on replayed graphs of G = 1, 2
  and 5 steps with ``history_chunk=3``: the histories ``np.array_equal``
  the per-step driver's;
* (e) the same solves against the JAX package's
  ``minimize_proximal_gradient`` and ``minimize_proximal_gradient_batch``
  in x64, in the m >= 3 class: equal ``nit``, x within 1e-6, inner counts
  within 25%;
* (f) the graph key separating ``max_iter_internal`` and
  ``tol_internal``.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import _Replay, _bitwise, _quiet, graphed  # noqa: F401
from test_torch_graph_backtracking import _same_result
from test_torch_graph_history import _same_batch, _same_history

import zfista_tpu.models as jm
from zfista_tpu.parallel import batch as jb
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.core import subproblem as ts
from zfista_tpu_torch.interop import problem_from_spec
from zfista_tpu_torch.ops.precision import lane_sum
from zfista_tpu_torch.ops.prox import project_simplex

F64 = torch.float64
TOL_INTERNAL = 1e-11

#: (JAX problem, sampling box, fixed-step lr): the zoo's m >= 3 problems
#: at small widths.
PROBLEMS = {
    "FDS": (jm.FDS(n_features=4), (-2.0, 2.0), 0.02),
    "FDS+l1": (jm.FDS(n_features=4, l1_ratios=[0.25] * 3, l1_shifts=[0.0, 1.0, -1.0]),
               (-2.0, 2.0), 0.02),
    "FDS box": (jm.FDS(n_features=4, bounds=(0.0, np.inf)), (0.0, 2.0), 0.02),
    "TRIDIA+l1": (jm.TRIDIA(l1_ratios=[0.5] * 3, l1_shifts=[0.0] * 3), (-1.0, 1.0), 0.02),
    "LFR1": (jm.LinearFunctionRank1(n_features=4, n_objectives=4), (-1.0, 1.0), 2e-3),
}


def _start(name, seed=42, lanes=None):
    jp, (lo, hi), _ = PROBLEMS[name]
    shape = (jp.n_features,) if lanes is None else (lanes, jp.n_features)
    return np.random.default_rng(seed).uniform(lo, hi, size=shape)


def _opts(name, mode, **extra):
    kw = dict(nesterov=True, tol=1e-6, tol_internal=TOL_INTERNAL, max_iter=15)
    if mode == "fixed":
        kw.update(decay_rate=1, lr=PROBLEMS[name][2])
    kw.update(extra)
    return kw


def _parts(name, mode, **extra):
    """The facade's step for ``name`` (options as :func:`_opts`), its start
    state and the owners it keys a graph by."""
    tp = problem_from_spec(PROBLEMS[name][0])
    fns = (tp.f, tp.g, tp.jac_f, tp.prox_wsum_g)
    x0 = torch.tensor(_start(name))
    fv, gv, jv, pv, m, _ = solver._normalize_problem(*fns, x0)
    kw = _opts(name, mode, **extra)
    opts = dict(tol=kw["tol"], tol_internal=kw["tol_internal"],
                max_iter_internal=kw.get("max_iter_internal", 100000),
                max_backtrack_iter=kw.get("max_backtrack_iter", 100),
                warm_start=kw.get("warm_start", False), decay_rate=kw.get("decay_rate", 0.5),
                nesterov=True, nesterov_ratio=(0, 0.25), deprecated=False,
                max_iter=kw["max_iter"])
    step = solver._make_step(fv, gv, jv, pv, m, **opts)
    state = solver.init_state(x0, fv(x0) + gv(x0), m, torch.tensor(kw.get("lr", 1.0), dtype=F64))
    return tp, step, state, fns


# -- (a) the arc searches on a trial axis ---------------------------------------


def _sequential_arcs(w, d_first, d_pg, bad, phi, grad, slack, value):
    """The JAX ``body``'s arc searches as its loops run them: trial by
    trial, ``a`` halved each time, the retry a ``lax.cond``."""

    def arc(d):
        a = torch.ones((), dtype=w.dtype)
        j = 0
        while True:
            j += 1
            w_t = project_simplex(w + a * d)
            phi_t = value(w_t)
            moved = torch.any(w_t != w)
            ok = bool(moved & (phi_t <= phi + 1e-4 * lane_sum(grad * (w_t - w)) + slack))
            if ok or j == ts.ARC_TRIALS:
                return ok, j, w_t, phi_t
            a = a * 0.5

    ok1, n1, w1, phi1 = arc(d_first)
    if ok1 or bad:
        ok2, n2, w2, phi2 = ok1, 0, w1, phi1
    else:
        ok2, n2, w2, phi2 = arc(d_pg)
    ok = ok1 or ok2
    w_new = w1 if ok1 else w2
    phi_new = phi1 if ok1 else phi2
    return ok, n1 + n2, (w_new if ok else w), (phi_new if ok else phi)


def _quadratic(m, seed):
    """A strongly convex quadratic on the simplex and its gradient at a
    point, with values summed as the trial axis sums them."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((m, m))
    Q = torch.tensor(Q @ Q.T + m * np.eye(m))
    c = torch.tensor(rng.standard_normal(m))

    def value(w):
        return 0.5 * lane_sum(w * lane_sum(Q * w, dim=-1)) + lane_sum(c * w)

    def values(W):
        return torch.func.vmap(value)(W)

    return Q, c, value, values


@pytest.mark.parametrize(
    "case", ["newton at 1", "newton halved", "pg retry", "none accepted", "bad skip"]
)
def test_arc_trial_axis_is_the_sequential_search(case):
    """Both arcs on one trial axis give the sequential search's accepted
    point, value and count, bit for bit: the Newton arc accepted at its
    first trial or after halvings, the projected-gradient retry, no trial
    of either arc accepted (80 trials counted), and ``bad``, where the
    retry is skipped and its trials not counted."""
    m = 4
    Q, c, value, values = _quadratic(m, seed=3)
    w = project_simplex(torch.tensor([0.4, 0.3, 0.2, 0.1], dtype=F64))
    phi = value(w)
    grad = Q @ w + c
    w_pg = project_simplex(w - grad / 50.0)
    d_pg = w_pg - w
    # The Newton step along the simplex: [Q 1; 1' 0] [d; nu] = [-grad; 0].
    kkt = torch.zeros((m + 1, m + 1), dtype=F64)
    kkt[:m, :m], kkt[:m, m], kkt[m, :m] = Q, 1.0, 1.0
    newton = torch.linalg.solve(kkt, torch.cat([-grad, torch.zeros(1, dtype=F64)]))[:m]
    d_first, bad = {
        "newton at 1": (0.05 * newton / newton.abs().max(), False),
        "newton halved": (40.0 * newton / newton.abs().max(), False),
        "pg retry": (-d_pg, False),  # an ascent direction: every Newton trial fails
        "none accepted": (-d_pg, False),
        "bad skip": (-d_pg, True),
    }[case]
    slack = 4 * 2.2e-16 * (1 + torch.abs(phi))
    if case == "none accepted":
        d_pg = -d_pg  # both arcs ascend
    ref = _sequential_arcs(w, d_first, d_pg, torch.tensor(bad), phi, grad, slack, value)
    got = ts.arc_searches(w, d_first, d_pg, torch.tensor(bad), phi, grad, slack, values)
    assert bool(got[0]) == ref[0] and int(got[1]) == ref[1]
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    expect = {"newton at 1": (True, 1), "pg retry": (True, None), "none accepted": (False, 80),
              "bad skip": (False, 40)}.get(case)
    if case == "newton halved":
        assert ref[0] and 1 < ref[1] < ts.ARC_TRIALS
    elif expect[1] is None:
        assert ref[0] and ref[1] > ts.ARC_TRIALS
    else:
        assert (ref[0], ref[1]) == expect
    if not ref[0]:
        assert torch.equal(got[2], w) and torch.equal(got[3], phi)


def test_newton_iteration_is_the_same_at_any_lane_count():
    """One Newton iteration of FDS+l1's dual (its Hessian, the KKT step and
    both arcs) in a lane of 8 equals the same lane among 3 and alone under
    ``vmap``, bit for bit: no sum depends on the lanes beside it."""
    tp = problem_from_spec(PROBLEMS["FDS+l1"][0])
    rng = np.random.default_rng(1)
    ys = torch.tensor(rng.uniform(-1.0, 1.0, (8, 4)))
    f_y = torch.func.vmap(tp.f)(ys)
    jac = torch.func.vmap(tp.jac_f)(ys)
    F_old = f_y + torch.func.vmap(tp.g)(ys) + 0.1
    lr = torch.tensor(rng.uniform(0.05, 0.5, 8))
    w0 = torch.full((8, 3), 1.0 / 3, dtype=F64)
    parts = ts.make_batch_newton(lambda x: tp.g(x), lambda w, x: tp.prox_wsum_g(w, x), 3, None,
                                 tol=TOL_INTERNAL, max_iter=100)
    data = (lr, F_old, ys, f_y, jac)

    def two(idx):
        d = tuple(v[idx] for v in data)
        c = parts.iterate(parts.start(*d, w0[idx]), *d)
        return parts.iterate(c, *d)

    full = two(slice(None))
    for idx in (slice(2, 5), slice(6, 7)):
        part = two(idx)
        for a, b in zip(part, full):
            assert torch.equal(a, b[idx])
    assert len(set(full.nit.tolist())) > 1


# -- (b) the single solve's carried Newton steps --------------------------------


CASES_B = [(name, mode) for name in PROBLEMS for mode in ("backtracking", "fixed")]


@pytest.mark.parametrize("name, mode", CASES_B, ids=[f"{n}-{m}" for n, m in CASES_B])
def test_carried_newton_solve_is_bitwise_check_every_1(graphed, name, mode):
    """The carried Newton steps on the graphed driver at chunks of 1, 3
    and 8 against the per-iteration step at ``check_every=1``: every State
    field bit for bit, the search's and the Newton fields back at an
    iteration's start; the public solve at ``check_every=8`` replays and
    is the ``check_every=1`` solve in every field."""
    tp, step, state, owners = _parts(name, mode)
    search = step.carried_search
    assert search.capturable and search.masks_itself and not getattr(step, "capturable", False)
    assert search.options[0] == "newton search"
    max_iter = _opts(name, mode)["max_iter"]
    active = lambda s: solver._active(s, max_iter)  # noqa: E731
    ref = solver.run_masked(step, state, active, 1)
    for ce in (1, 3, 8):
        made = _Replay.made
        got = solver.run_graphed(search, search.start(state), active, ce, owners)
        _bitwise(got.state(), ref)
        assert int(got.k) == int(got.spent) == int(got.newton_nit) == 0
        assert _Replay.made == made + 1
    kw = _opts(name, mode)
    x0 = torch.tensor(_start(name))
    eager = _quiet(tp.solve, x0, check_every=1, **kw)
    got = _quiet(tp.solve, x0, check_every=8, **kw)
    assert _Replay.made == 4 and next(reversed(graphed.values())).graph.replays >= 1
    _same_result(got, eager)
    _bitwise(eager.state, ref)


@pytest.mark.parametrize(
    "extra", [{"warm_start": True}, {"max_iter_internal": 0}, {"max_iter_internal": 1},
              {"warm_start": True, "decay_rate": 1, "lr": 0.02}],
    ids=["warm_start", "max_iter_internal 0", "max_iter_internal 1", "warm_start fixed"],
)
def test_carried_newton_options_are_bitwise(graphed, extra):
    """FDS+l1 with ``warm_start`` (the trial's weight carried into the
    next, backtracking and fixed) and at ``max_iter_internal`` 0 (no
    Newton iteration: the trial ends at its start with ``nit`` 1) and 1,
    at ``check_every=3``: bitwise the ``check_every=1`` solve."""
    tp = problem_from_spec(PROBLEMS["FDS+l1"][0])
    x0 = torch.tensor(_start("FDS+l1"))
    kw = _opts("FDS+l1", "backtracking", **extra)
    eager = _quiet(tp.solve, x0, check_every=1, **kw)
    got = _quiet(tp.solve, x0, check_every=3, **kw)
    assert _Replay.made == 1
    _same_result(got, eager)
    if extra.get("max_iter_internal") == 0:
        # One inner iteration per trial: the solve's trials, counted.
        assert eager.nit_internal >= eager.nit


# -- (c) the batch's per-lane carried Newton steps ------------------------------


def _batch(name, lanes=8, **extra):
    tp = problem_from_spec(PROBLEMS[name][0])
    kw = _opts(name, "backtracking", **extra)
    return tp, torch.tensor(_start(name, seed=7, lanes=lanes)), kw


@pytest.mark.parametrize("name", ["FDS+l1", "TRIDIA+l1", "LFR1"])
def test_carried_newton_batch_is_bitwise_the_rounds(graphed, name):
    """Every lane one Newton iteration of its own trial a step, at
    ``check_every=8`` on replayed graphs: every field of every lane bitwise
    the round-based ``check_every=1`` batch, whose lanes took different
    Newton counts."""
    tp, x0s, kw = _batch(name, max_iter=12)
    ref = _quiet(tp.solve_batch, x0s, check_every=1, **kw)
    got = _quiet(tp.solve_batch, x0s, check_every=8, **kw)
    assert _Replay.made == 1 and next(iter(graphed))[0][0] == "batch newton search"
    assert len(set(ref.nit_internal.tolist())) > 4
    _same_batch(got, ref)


@pytest.mark.parametrize("how", ["fails at 3 trials", "lane_chunk", "fixed step"])
def test_carried_newton_batch_fails_chunks_and_fixes(graphed, how):
    """A lane whose ``lr`` starts at 1e4 fails at ``max_backtrack_iter=3``
    (status 2, its trials counted, x its start) beside lanes that go on;
    the batch under ``lane_chunk=4``; the fixed step: each at
    ``check_every=8`` bitwise the round-based batch."""
    tp, x0s, kw = _batch("FDS+l1", max_iter=12)
    if how == "fails at 3 trials":
        start = _quiet(tp.solve_batch, x0s, max_iter=0, **{k: v for k, v in kw.items()
                                                           if k != "max_iter"}).state
        start = start._replace(lr=np.where(np.arange(8) == 3, 1e4, 0.05))
        kw.update(max_backtrack_iter=3, initial_states=start)
    elif how == "lane_chunk":
        kw.update(lane_chunk=4)
    else:
        kw.update(decay_rate=1, lr=0.02)
    ref = _quiet(tp.solve_batch, x0s, check_every=1, **kw)
    got = _quiet(tp.solve_batch, x0s, check_every=8, **kw)
    assert _Replay.made == 1  # both lane chunks replay one graph
    _same_batch(got, ref)
    if how == "fails at 3 trials":
        assert ref.status[3] == 2 and ref.nit[3] == 0 and ref.nit_internal[3] > 3
        assert np.all(np.delete(ref.nit, 3) > 0)
        np.testing.assert_array_equal(got.x[3], x0s[3].numpy())


# -- (d) the history drivers ------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2, 5])
def test_graphed_m3_histories_are_the_per_step_histories(graphed, monkeypatch, G):
    """FDS+l1's ``return_all`` and its batch with ``history=True`` and
    ``record_vecs`` on replayed graphs of G Newton steps,
    ``history_chunk=3``: every history array and the final State
    ``np.array_equal`` the per-step driver's; one capture each."""
    tp = problem_from_spec(PROBLEMS["FDS+l1"][0])
    kw = _opts("FDS+l1", "backtracking", max_iter=8, history_chunk=3)
    x0 = torch.tensor(_start("FDS+l1"))
    x0s = torch.tensor(_start("FDS+l1", seed=7, lanes=8))
    runs = {
        "return_all": lambda: _quiet(tp.solve, x0, return_all=True, **kw),
        "batch": lambda: _quiet(tp.solve_batch, x0s, history=True, record_vecs=True, **kw),
    }
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {})
    refs = {k: run() for k, run in runs.items()}
    assert _Replay.made == 0
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {3: G})
    got = {k: run() for k, run in runs.items()}
    assert _Replay.made == 2
    r, g = refs["return_all"], got["return_all"]
    _bitwise(g.state, r.state)
    assert len(g.allvecs) == r.nit + 1
    for k in ("allvecs", "allfuns", "allerrs"):
        assert np.array_equal(np.asarray(getattr(g, k)), np.asarray(getattr(r, k))), k
    _same_history(got["batch"], refs["batch"])


# -- (e) against the JAX package -------------------------------------------------


def _in_class(got, ref):
    np.testing.assert_array_equal(np.asarray(got.nit), np.asarray(ref.nit))
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x), rtol=0, atol=1e-6)
    inner, jinner = np.asarray(got.nit_internal), np.asarray(ref.nit_internal)
    assert np.all(np.abs(inner - jinner) <= 0.25 * jinner)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_carried_newton_solve_matches_jax(graphed, name):
    """Each problem's backtracking solve at ``check_every=8`` (replayed
    carried Newton steps) against JAX x64: equal nit, x within 1e-6, inner
    counts within 25%."""
    jp = PROBLEMS[name][0]
    kw = _opts(name, "backtracking", max_iter=200)
    x0 = _start(name)
    rj = _quiet(jp.solve, jnp.asarray(x0), **kw)
    got = _quiet(problem_from_spec(jp).solve, torch.tensor(x0), check_every=8, **kw)
    assert _Replay.made == 1 and got.status == rj.status
    _in_class(got, rj)


@pytest.mark.slow
def test_carried_newton_batch_matches_jax(graphed):
    """FDS+l1 from 8 starts at ``check_every=8`` against the JAX batch in
    x64 (a vmapped m >= 3 program: seconds to compile): equal nit, x within
    1e-6, inner counts within 25% per lane."""
    jp = PROBLEMS["FDS+l1"][0]
    kw = _opts("FDS+l1", "backtracking", max_iter=200)
    x0s = _start("FDS+l1", seed=7, lanes=8)
    rj = _quiet(jb.minimize_proximal_gradient_batch, jp.f, jp.g, jp.jac_f, jp.prox_wsum_g,
                jnp.asarray(x0s), **kw)
    got = _quiet(problem_from_spec(jp).solve_batch, torch.tensor(x0s), check_every=8, **kw)
    assert _Replay.made == 1
    np.testing.assert_array_equal(got.status, np.asarray(rj.status))
    _in_class(got, rj)


# -- (f) the graph key --------------------------------------------------------------


@pytest.mark.parametrize("option, value", [("max_iter_internal", 7), ("tol_internal", 1e-9)])
def test_graph_key_separates_the_subproblem_options(graphed, option, value):
    """Two carried Newton searches that differ only in ``max_iter_internal``
    (the Newton cap) or ``tol_internal`` (the stationarity test) never
    share a graph: the keys differ, and each solve captures its own graph,
    bitwise its ``check_every=1`` solve."""
    _, base, state, owners = _parts("FDS+l1", "backtracking")
    _, other, _, _ = _parts("FDS+l1", "backtracking", **{option: value})
    carry = base.carried_search.start(state)
    key_a, _ = solver._graph_key(base.carried_search, carry, 8, owners)
    key_b, _ = solver._graph_key(other.carried_search, carry, 8, owners)
    assert key_a != key_b
    tp = problem_from_spec(PROBLEMS["FDS+l1"][0])
    x0 = torch.tensor(_start("FDS+l1"))
    for extra in ({}, {option: value}):
        kw = _opts("FDS+l1", "backtracking", **extra)
        _same_result(_quiet(tp.solve, x0, check_every=8, **kw),
                     _quiet(tp.solve, x0, check_every=1, **kw))
    assert _Replay.made == 2 and len(graphed) == 2
