"""The batch's backtracking as per-lane carried trials, and the history
drivers as replayed CUDA graphs, on the CPU.

With the stand-in graph of tests/test_torch_graph.py (its "capture" runs
the chunk and restores the static buffers, its replay runs the chunk with
the launch counters held) and graphs allowed on the CPU:

* (a) a backtracking batch at m <= 2 runs one line-search trial in every
  lane a step (``step.carried_search``), each lane at its own trial of its
  own iteration: at chunks of 1, 3, 7 and 64 (the driver) and at
  ``check_every`` 3, 7 and 64 (the facade), every field of every lane
  bitwise the round-based ``check_every=1`` batch, with ``nit``,
  ``nit_internal`` and ``status``; on a steep LASSO lambda sweep whose
  lanes take different trial counts, and on JOS1 with its l1 terms at
  m = 2 (with and without ``warm_start`` and ``deprecated``) and SD with
  ``project_momentum``;
* (b) a lane that fails at ``max_backtrack_iter=3`` while the lanes beside
  it converge;
* (c) the batch history on replayed graphs of G = 1, 3 and 8 steps,
  ``history_chunk=5``, ``record_vecs``: ``allfuns``, ``allerrs``,
  ``history_mask`` and ``allvecs`` ``np.array_equal`` the per-step
  driver's, for the fixed-lr step and the carried trials, from
  ``initial_states`` and under ``lane_chunk``, and ``to_list()`` equal;
* (d) the single solve's ``return_all`` on the graphed driver: the LASSO
  fixed step and the backtracking JOS1, ``allvecs``, ``allfuns`` and
  ``allerrs`` bitwise the per-step driver's;
* (e) the same batches against the JAX package's
  ``minimize_proximal_gradient_batch`` in x64: m = 1 equal ``nit``, x
  within 1e-10; m = 2 equal ``nit``, x within 1e-8;
* (f) the graph key separating ``decay_rate`` and ``max_backtrack_iter``;
* (g) an m >= 3 batch and an m >= 3 ``return_all`` never reach the graph
  factory;
* ``bench.history_bench``'s first solves in turns, on the stand-in graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import _Replay, _bitwise, _quiet, graphed  # noqa: F401
from test_torch_graph_backtracking import _jos1, _steep_lasso

from zfista_tpu.models import lasso as jl
from zfista_tpu.parallel import batch as jb
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import FDS, SD, Lasso
from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
from zfista_tpu_torch.parallel import batch as tb
from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

F64 = torch.float64
HIST = ("allfuns", "allerrs", "history_mask", "allvecs")


def _sweep(lanes=16):
    """The steep LASSO (``1/L < 2**-10``) as a lambda sweep of ``lanes``
    lanes, 0.5 to 20 (lanes x n a multiple of 16, for the CPU's bitwise
    tests): from ``lr=1`` at decay 0.5 each lane takes its own trials."""
    A, b = _steep_lasso()
    fns = make_lasso_lambda_sweep(torch.tensor(A), torch.tensor(b))
    lams = torch.tensor(np.geomspace(0.5, 20.0, lanes))
    x0s = torch.zeros((lanes, A.shape[1]), dtype=F64)
    return fns, x0s, lams, (A, b)


def _same_batch(got, ref):
    _bitwise(got.state, ref.state)
    for k in ("nit", "nit_internal", "status", "x", "fun"):
        assert np.array_equal(got[k], ref[k]), k


def _same_history(got, ref):
    _same_batch(got, ref)
    for k in HIST:
        if ref.get(k) is not None:
            # NaN: the rows a lane chunk is padded with to the longest.
            nan = ref[k].dtype != np.bool_
            assert got[k].dtype == ref[k].dtype
            assert np.array_equal(got[k], ref[k], equal_nan=nan), k
    for a, c in zip(got.to_list(), ref.to_list()):
        assert (a.nit, a.nit_internal, a.status) == (c.nit, c.nit_internal, c.status)
        assert np.array_equal(np.asarray(a.allfuns), np.asarray(c.allfuns))
        assert np.array_equal(np.asarray(a.allerrs), np.asarray(c.allerrs))
        if c.get("allvecs") is not None:
            assert np.array_equal(np.asarray(a.allvecs), np.asarray(c.allvecs))


def _batch_parts(fns, x0s, lams, **kw):
    """The batch facade's step, start states and owners for a lambda sweep
    (Nesterov, lr 1, decay 0.5)."""
    lane0 = lams[0]
    fv, gv, jv, pv, m, _ = solver._normalize_problem(*fns, x0s[0], lane0)
    opts = dict(tol=1e-6, tol_internal=1e-12, max_iter_internal=100000, max_backtrack_iter=100,
                warm_start=False, decay_rate=0.5, nesterov=True, nesterov_ratio=(0, 0.25),
                deprecated=False, max_iter=100_000)
    opts.update(kw)
    step = solver._make_batch_step(fv, gv, jv, pv, m, lams, **opts)
    F0 = torch.func.vmap(lambda x, p: fv(x, p) + gv(x, p))(x0s, lams)
    states = tb._init_states(x0s, F0, m, 1.0)
    return step, states, (*fns, lams), opts["max_iter"]


def test_carried_batch_search_driver_is_bitwise_the_rounds(graphed):
    """The carried batch search on ``run_graphed`` at chunks of 1, 3, 7
    and 64 against the round-based step at ``check_every=1``: every lane's
    State bit for bit, its search fields back at an iteration's start; the
    lanes took different trial counts, and the batch took as many steps
    as its slowest lane took trials."""
    fns, x0s, lams, _ = _sweep()
    step, states, owners, max_iter = _batch_parts(fns, x0s, lams)
    search = step.carried_search
    assert search.capturable and search.masks_itself and not getattr(step, "capturable", False)
    active = lambda s: torch.any(solver._active(s, max_iter))  # noqa: E731
    ref = solver.run_masked(step, states, active, 1)
    trials = ref.nit_internal  # one inner iteration per m = 1 trial
    assert torch.all(ref.converged) and len(set(trials.tolist())) > 4
    for ce in (1, 3, 7, 64):
        made = _Replay.made
        got = solver.run_graphed(search, solver._Search.start(states), active, ce, owners)
        _bitwise(got.state(), ref)
        assert not torch.any(got.k) and not torch.any(got.spent)
        assert torch.equal(got.lr_try, ref.lr)
        assert _Replay.made == made + 1
        entry = next(reversed(graphed.values()))
        assert entry.graph.replays == -(-int(trials.max()) // ce) - 1


@pytest.mark.parametrize("check_every", [3, 7, 64])
def test_backtracking_sweep_facade_is_bitwise_and_matches_jax(graphed, check_every):
    """The public batch at ``check_every`` 3, 7 and 64 runs the carried
    trials on replayed graphs, every field of every lane bitwise its
    ``check_every=1`` batch, a repeat on the cached graph too; against the
    JAX batch in x64 equal nit and nit_internal, x within 1e-10 (m = 1)."""
    fns, x0s, lams, (A, b) = _sweep()
    kw = dict(batch_params=lams, nesterov=True, tol=1e-6)
    ref = minimize_proximal_gradient_batch(*fns, x0s, check_every=1, **kw)
    assert _Replay.made == 0 and np.all(ref.status == 1)
    got = minimize_proximal_gradient_batch(*fns, x0s, check_every=check_every, **kw)
    again = minimize_proximal_gradient_batch(*fns, x0s, check_every=check_every, **kw)
    assert _Replay.made == 1 and len(graphed) == 1
    assert next(iter(graphed))[0][0] == "batch search"
    _same_batch(got, ref)
    _same_batch(again, ref)
    rj = jb.minimize_proximal_gradient_batch(
        *jl.make_lasso_lambda_sweep(A, b), jnp.asarray(x0s.numpy()),
        batch_params=jnp.asarray(lams.numpy()), nesterov=True, tol=1e-6,
    )
    np.testing.assert_array_equal(got.nit, np.asarray(rj.nit))
    np.testing.assert_array_equal(got.nit_internal, np.asarray(rj.nit_internal))
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize(
    "case", ["jos1", "jos1 warm_start", "jos1 deprecated", "sd project_momentum"]
)
def test_m2_backtracking_batches_are_bitwise_and_match_jax(graphed, case):
    """JOS1 (n=20, its l1 terms) at m = 2 from 8 starts, backtracking from lr
    30 by 0.5 (with ``warm_start``, ``deprecated``), and SD (bounded) with
    ``project_momentum``: at ``check_every=8`` on replayed graphs, bitwise
    the ``check_every=1`` batch per lane; against the JAX batch in x64
    equal nit, x within 1e-8 (the m = 2 class)."""
    from zfista_tpu.models import SD as JSD

    if case.startswith("jos1"):
        prob, jprob, _ = _jos1()
        x0s = np.random.default_rng(3).uniform(-2.0, 4.0, size=(8, 20))
        kw = dict(nesterov=True, tol=1e-6, lr=30.0)
        kw.update({"jos1 warm_start": dict(warm_start=True),
                   "jos1 deprecated": dict(deprecated=True)}.get(case, {}))
    else:
        prob, jprob = SD(), JSD()
        x0s = np.random.default_rng(3).uniform(1.0, 2.0, size=(16, prob.n_features))
        kw = dict(nesterov=True, tol=1e-6, lr=5.0, project_momentum=True)
    ref = _quiet(prob.solve_batch, torch.tensor(x0s), check_every=1, **kw)
    got = _quiet(prob.solve_batch, torch.tensor(x0s), check_every=8, **kw)
    assert _Replay.made == 1 and np.all(ref.status == 1)
    assert len(set(zip(ref.nit.tolist(), ref.nit_internal.tolist()))) > 1
    _same_batch(got, ref)
    rj = _quiet(jprob.solve_batch, jnp.asarray(x0s), **kw)
    np.testing.assert_array_equal(got.nit, np.asarray(rj.nit))
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-8)


def test_a_lane_fails_alone_at_three_trials(graphed):
    """From ``initial_states`` with one lane's ``lr`` at 1 and the others'
    at a step they accept, ``max_backtrack_iter=3``: that lane fails its
    first line search (status 2, nit 0, its 3 trials counted, x its start)
    while the others converge; the carried batch at ``check_every=8`` is
    bitwise the round-based one."""
    fns, x0s, lams, (A, b) = _sweep()
    step, states, _, _ = _batch_parts(fns, x0s, lams)
    lr = torch.full((16,), 1.0 / (2 * np.linalg.norm(A, 2) ** 2), dtype=F64)
    lr[5] = 1.0
    start = states._replace(lr=lr)
    kw = dict(batch_params=lams, nesterov=True, tol=1e-6, max_backtrack_iter=3,
              initial_states=start)
    ref = _quiet(minimize_proximal_gradient_batch, *fns, x0s, check_every=1, **kw)
    got = _quiet(minimize_proximal_gradient_batch, *fns, x0s, check_every=8, **kw)
    assert _Replay.made == 1
    assert ref.status[5] == 2 and (ref.nit[5], ref.nit_internal[5]) == (0, 3)
    assert np.all(np.delete(ref.status, 5) == 1)
    np.testing.assert_array_equal(got.x[5], x0s[5].numpy())
    _same_batch(got, ref)


def _history_case(kind, G, **extra):
    """A sweep batch with ``history=True``, ``record_vecs`` and
    ``history_chunk=5``: ``kind`` "fixed" (decay 1 at 1/L) or "carried"
    (backtracking from lr 1)."""
    fns, x0s, lams, (A, b) = _sweep()
    kw = dict(batch_params=lams, nesterov=True, tol=1e-6, history=True, record_vecs=True,
              history_chunk=5, max_iter=300)
    if kind == "fixed":
        kw.update(decay_rate=1, lr=1.0 / (2 * np.linalg.norm(A, 2) ** 2))
    kw.update(extra)
    return fns, x0s, kw


@pytest.mark.parametrize("kind", ["fixed", "carried"])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_graphed_batch_history_is_the_per_step_history(graphed, monkeypatch, kind, G):
    """The batch history on replayed graphs of G steps against the
    per-step driver: the four history arrays and the final State
    ``np.array_equal``, ``to_list()`` equal per lane, one host read per
    replay (the replays counted)."""
    fns, x0s, kw = _history_case(kind, G)
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {})
    ref = _quiet(minimize_proximal_gradient_batch, *fns, x0s, **kw)
    assert _Replay.made == 0 and ref.allfuns.shape[1] == int(ref.nit.max())
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {1: G})
    got = _quiet(minimize_proximal_gradient_batch, *fns, x0s, **kw)
    assert _Replay.made == 1
    (entry,) = graphed.values()
    steps = int(ref.nit.max()) if kind == "fixed" else int(ref.nit_internal.max())
    assert entry.graph.replays == -(-steps // G) - 1
    assert entry.records[0].shape == (G, 16)
    _same_history(got, ref)


@pytest.mark.parametrize("how", ["resume", "lane_chunk", "stops at max_iter"])
def test_graphed_batch_history_resumes_and_chunks_lanes(graphed, monkeypatch, how):
    """The graphed history of the carried trials from ``initial_states``
    (lanes resumed at different ``nit``), under ``lane_chunk=6`` (padded
    chunks, merged to the longest history) and stopped at a ``max_iter``
    that cuts lanes mid-run: each ``np.array_equal`` the per-step
    driver's."""
    fns, x0s, kw = _history_case("carried", 3)
    if how == "resume":
        # Even lanes resumed after 9 iterations, odd lanes after 14.
        heads = [
            _quiet(minimize_proximal_gradient_batch, *fns, x0s,
                   **{**kw, "history": False, "record_vecs": False, "max_iter": it}).state
            for it in (9, 14)
        ]
        odd = (np.arange(16) % 2 == 1).reshape(-1, 1)
        kw["initial_states"] = solver.State(
            *(np.where(odd.reshape((-1,) + (1,) * (a.ndim - 1)), c, a) for a, c in zip(*heads))
        )
    elif how == "lane_chunk":
        kw["lane_chunk"] = 6
    else:
        kw["max_iter"] = 23
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {})
    ref = _quiet(minimize_proximal_gradient_batch, *fns, x0s, **kw)
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {1: 3})
    got = _quiet(minimize_proximal_gradient_batch, *fns, x0s, **kw)
    assert _Replay.made >= 1
    if how == "stops at max_iter":
        assert np.all(ref.nit == 23) and np.all(ref.status == 0)
    _same_history(got, ref)


def test_graphed_m2_history_with_a_failing_lane(graphed, monkeypatch):
    """JOS1 at m = 2, backtracking with ``max_backtrack_iter=3``, resumed
    from states whose lanes 2 and 5 start at lr 1e6 (the others at 30): those
    fail their first line search (the failure row unrecorded, the rows
    after it frozen) beside lanes that converge; the graphed history of
    G = 4 is the per-step driver's bitwise."""
    prob, _, _ = _jos1()
    x0s = torch.tensor(np.random.default_rng(5).uniform(-2.0, 4.0, size=(8, 20)))
    start = prob.solve_batch(x0s, lr=30.0, max_iter=0).state
    start = start._replace(lr=np.where(np.isin(np.arange(8), (2, 5)), 1e6, 30.0))
    kw = dict(nesterov=True, tol=1e-6, max_backtrack_iter=3, history=True, record_vecs=True,
              history_chunk=5, initial_states=start)
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {})
    ref = _quiet(prob.solve_batch, x0s, **kw)
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {2: 4})
    got = _quiet(prob.solve_batch, x0s, **kw)
    assert _Replay.made == 1
    assert ref.status.tolist() == [1, 1, 2, 1, 1, 2, 1, 1] and ref.allfuns.shape[1] > 4
    _same_history(got, ref)


@pytest.mark.parametrize("case", ["lasso fixed step", "jos1 backtracking"])
def test_graphed_return_all_is_the_per_step_history(graphed, monkeypatch, case):
    """The single solve's ``return_all`` on the graphed driver (G = 3,
    ``history_chunk=5``): ``allvecs``, ``allfuns`` and ``allerrs`` bitwise
    the per-step driver's, and the final State."""
    if case == "lasso fixed step":
        A, b = _steep_lasso()
        prob = Lasso(A, b, 5.0, device="cpu")
        x0 = np.zeros(A.shape[1])
        lr = 1.0 / (2 * np.linalg.norm(A, 2) ** 2)
        solve = lambda: _quiet(prob.solve_fixed_step, x0, lr=lr, tol=1e-6,  # noqa: E731
                               return_all=True, history_chunk=5)
    else:
        prob, _, x0 = _jos1()
        solve = lambda: _quiet(prob.solve, torch.tensor(x0), nesterov=True, tol=1e-6,  # noqa: E731
                               lr=30.0, return_all=True, history_chunk=5)
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {})
    ref = solve()
    monkeypatch.setattr(solver, "HISTORY_GRAPH_STEPS", {1: 3, 2: 3})
    got = solve()
    assert _Replay.made == 1 and ref.status == 1 and ref.nit > 6
    _bitwise(got.state, ref.state)
    assert len(got.allvecs) == len(ref.allvecs) == ref.nit + 1
    assert np.array_equal(np.stack(got.allvecs), np.stack(ref.allvecs))
    assert np.array_equal(np.asarray(got.allfuns), np.asarray(ref.allfuns))
    assert np.array_equal(np.asarray(got.allerrs), np.asarray(ref.allerrs))


@pytest.mark.parametrize("option, value", [("decay_rate", 0.6), ("max_backtrack_iter", 50)])
def test_graph_key_separates_the_batch_search_options(graphed, option, value):
    """Two carried batch searches that differ only in ``decay_rate`` or
    ``max_backtrack_iter`` never share a graph: the keys differ, and each
    batch captures its own graph, bitwise its ``check_every=1`` batch."""
    fns, x0s, lams, _ = _sweep()
    base, states, owners, _ = _batch_parts(fns, x0s, lams)
    other, _, _, _ = _batch_parts(fns, x0s, lams, **{option: value})
    carry = solver._Search.start(states)
    key_a, _ = solver._graph_key(base.carried_search, carry, 8, owners)
    key_b, _ = solver._graph_key(other.carried_search, carry, 8, owners)
    assert key_a != key_b
    assert base.carried_search.options[:-2] == other.carried_search.options[:-2]
    for kw in ({}, {option: value}):
        args = dict(batch_params=lams, nesterov=True, tol=1e-6, **kw)
        ref = minimize_proximal_gradient_batch(*fns, x0s, check_every=1, **args)
        got = minimize_proximal_gradient_batch(*fns, x0s, check_every=8, **args)
        _same_batch(got, ref)
    assert _Replay.made == 2 and len(graphed) == 2


@pytest.mark.parametrize("how", ["batch", "batch history", "return_all"])
def test_m3_solves_never_reach_the_graph_factory(graphed, how):
    """FDS (m = 3): a backtracking batch at ``check_every=8``, a batch with
    history and a ``return_all`` solve stay on their eager drivers (the
    Newton loop reads the host): no graph is made, and each is bitwise its
    ``check_every=1`` run."""
    p = FDS(n_features=10)
    x0s = torch.tensor(np.random.default_rng(1).uniform(-2.0, 2.0, size=(4, 10)))
    kw = dict(nesterov=True, max_iter=6, tol=0)
    if how == "return_all":
        ref = _quiet(p.solve, x0s[0], **kw)
        got = _quiet(p.solve, x0s[0], return_all=True, **kw)
        assert len(got.allvecs) == ref.nit + 1
    else:
        ref = _quiet(p.solve_batch, x0s, **kw)
        extra = dict(check_every=8) if how == "batch" else dict(history=True)
        got = _quiet(p.solve_batch, x0s, **kw, **extra)
    assert _Replay.made == 0 and len(graphed) == 0
    _bitwise(got.state, ref.state)


def test_history_rule(monkeypatch):
    """``_history_steps``: the steps of ``HISTORY_GRAPH_STEPS`` for a
    capturable step with owners on a card and a ``max_iter`` past one
    replay, else 0 (the per-step driver): on the CPU, at m >= 3, for a
    step that is not capturable, without owners, at a short ``max_iter``."""
    fns, x0s, lams, _ = _sweep()
    step, states, owners, _ = _batch_parts(fns, x0s, lams)
    search = step.carried_search
    rule = solver._history_steps
    assert solver.HISTORY_GRAPH_STEPS == {1: 4, 2: 2}
    assert rule(search, states, 100, owners, 1) == 0  # the CPU
    monkeypatch.setattr(solver, "_graphs_run_on", lambda device: True)
    assert rule(search, states, 100, owners, 1) == 4
    assert rule(search, states, 100, owners, 2) == 2
    assert rule(search, states, 4, owners, 1) == 0
    assert rule(search, states, 100, None, 1) == 0
    assert rule(search, states, 100, owners, 3) == 0
    assert rule(step, states, 100, owners, 1) == 0  # the round-based step reads the host


def test_history_bench_times_first_solves_in_turns(graphed, monkeypatch):
    """``bench.history_bench.in_turns`` on the stand-in graph: the carried
    sweep batch with history as first solves at G = 0 (the per-step
    driver) and 3, two turns in reversed order: no graph at 0, one capture
    and its replays at 3, every run bitwise the first, and the steps
    table as it was after each."""
    from zfista_tpu_torch.bench import history_bench

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    fns, x0s, kw = _history_case("carried", 3)
    table = dict(solver.HISTORY_GRAPH_STEPS)
    run = lambda: _quiet(minimize_proximal_gradient_batch, *fns, x0s, **kw)  # noqa: E731
    out = history_bench.in_turns(1, (0, 3), run, history_bench.batch_arrays, 2)
    assert out["bitwise"] and solver.HISTORY_GRAPH_STEPS == table
    assert {k: len(w) for k, w in out["walls"].items()} == {"0": 2, "3": 2}
    assert out["graphs"]["0"] == {"captures": 0, "replays": 0}
    assert out["graphs"]["3"]["captures"] == 1 and out["graphs"]["3"]["replays"] >= 1
    assert _Replay.made == 2
