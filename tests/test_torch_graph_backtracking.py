"""The backtracking line search as carried trials, and the batch's
fixed-lr chunk, as replayed CUDA graphs, on the CPU.

With the stand-in graph of tests/test_torch_graph.py (its "capture" runs
the chunk and restores the static carry, its replay runs the chunk with
the launch counters held) and graphs allowed on the CPU:

* a backtracking solve at m <= 2 with ``check_every > 1`` runs one trial
  of its line search per step (``step.carried_search``), graphed at
  chunks of 1, 3, 7 and 64, bitwise the per-iteration ``check_every=1``
  solve in every State field, ``nit``, ``nit_internal`` and status, on a
  small LASSO whose first iteration takes 12 trials (chunk boundaries fall
  mid-search), stopped by tol and by a ``max_iter`` that is not a multiple
  of the chunk, and resumed from ``initial_state``;
* JOS1 with its l1 terms at m = 2, with and without ``warm_start``,
  ``deprecated`` and ``tol_internal_rel``;
* a line search that fails at ``max_backtrack_iter=3`` (status 2);
* the same solves against the JAX package's ``minimize_proximal_gradient``
  in x64: equal ``nit`` and ``nit_internal``, x within 1e-10 (m = 1) and
  1e-8 (m = 2);
* the graph key separating ``decay_rate`` and ``max_backtrack_iter``, and
  ``check_every=None``'s rule (64 for an m = 1 fixed step on a card; 1 for
  a backtracking solve, on the CPU and for m >= 2);
* the batch's fixed-lr chunk graphed at ``check_every=8``, bitwise its
  ``check_every=1`` batch, with and without a per-lane momentum pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import _Replay, _bitwise, _quiet, graphed  # noqa: F401

from zfista_tpu.models import JOS1 as JJOS1
from zfista_tpu.models import lasso as jl
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import JOS1, Lasso
from zfista_tpu_torch.models.lasso import make_lasso_lambda_sweep
from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

F64 = torch.float64
LAM = 5.0


def _steep_lasso(seed=0, m=24, n=48, scale=12.0):
    """A LASSO with ``1/L < 2**-10``: from ``lr=1`` at decay 0.5 its first
    iteration takes 12 trials."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m) * scale
    x = np.zeros(n)
    x[rng.choice(n, 4, replace=False)] = rng.standard_normal(4)
    b = A @ x + 0.01 * rng.standard_normal(m)
    assert 2 * np.linalg.norm(A, 2) ** 2 > 2**10
    return A, b


def _same_result(got, ref):
    _bitwise(got.state, ref.state)
    assert (got.nit, got.nit_internal, got.status, got.message) == (
        ref.nit, ref.nit_internal, ref.status, ref.message)


def _facade_parts(A, b, max_iter, **kw):
    """The facade's backtracking step for ``Lasso(A, b, LAM)`` (Nesterov,
    lr 1, decay 0.5), its start state and the owners it keys a graph by."""
    prob = Lasso(A, b, LAM, device="cpu")
    fns = (prob.f, prob.g, prob.jac_f, prob.prox_wsum_g)
    x0 = torch.zeros(A.shape[1], dtype=F64)
    fv, gv, jv, pv, m, _ = solver._normalize_problem(*fns, x0)
    opts = dict(tol=1e-6, tol_internal=1e-12, max_iter_internal=100000, max_backtrack_iter=100,
                warm_start=False, decay_rate=0.5, nesterov=True, nesterov_ratio=(0, 0.25),
                deprecated=False, max_iter=max_iter)
    opts.update(kw)
    step = solver._make_step(fv, gv, jv, pv, m, **opts)
    state = solver.init_state(x0, fv(x0) + gv(x0), m, torch.tensor(1.0, dtype=F64))
    return prob, step, state, fns


@pytest.mark.parametrize("stop", ["converges", "max_iter 101"])
def test_carried_search_graphed_is_bitwise_the_per_iteration_step(graphed, stop):
    """``run_graphed`` over the carried trial at chunks of 1, 3, 7 and 64
    against ``run_masked`` of the per-iteration step at ``check_every=1``:
    every State field bit for bit, nit and nit_internal included, and the
    search's own fields back at an iteration's start."""
    A, b = _steep_lasso()
    max_iter = 100_000 if stop == "converges" else 101
    prob, step, state, owners = _facade_parts(A, b, max_iter, tol=1e-6 if stop == "converges" else 0.0)
    search = step.carried_search
    assert search.capturable and not getattr(step, "capturable", False)
    active = lambda s: solver._active(s, max_iter)  # noqa: E731
    ref = solver.run_masked(step, state, active, 1)
    assert int(ref.nit_internal) - int(ref.nit) >= 11  # the first iteration's retries
    if stop == "converges":
        # A trial a step: the last chunk ends past the last trial.
        assert bool(ref.converged) and all(int(ref.nit_internal) % ce for ce in (3, 7, 64))
    else:
        assert int(ref.nit) == 101 and not bool(ref.converged)
    for ce in (1, 3, 7, 64):
        made = _Replay.made
        got = solver.run_graphed(search, solver._Search.start(state), active, ce, owners)
        _bitwise(got.state(), ref)
        assert (int(got.k), int(got.spent)) == (0, 0)
        assert torch.equal(got.lr_try, ref.lr) and torch.equal(got.w_try, ref.w)
        assert _Replay.made == made + 1
        entry = next(reversed(graphed.values()))
        trials = int(ref.nit_internal)  # one inner iteration per m = 1 trial
        assert entry.graph.replays == -(-trials // ce) - 1  # the first chunk ran eagerly


@pytest.mark.parametrize("check_every", [3, 7, 64])
def test_backtracking_lasso_solve_graphed_matches_jax_and_eager(graphed, check_every):
    """``Lasso.solve`` (backtracking from lr 1) at ``check_every`` 3, 7 and
    64 runs the carried trials on replayed graphs, bitwise its
    ``check_every=1`` solve; against JAX x64 equal nit and nit_internal, x
    within 1e-10.  A repeat solve replays the cached graph."""
    A, b = _steep_lasso()
    x0 = np.zeros(A.shape[1])
    kw = dict(nesterov=True, tol=1e-6)
    rj = jl.Lasso(A, b, LAM).solve(jnp.asarray(x0), check_every=check_every, **kw)
    prob = Lasso(A, b, LAM, device="cpu")
    eager = prob.solve(x0, check_every=1, **kw)
    assert _Replay.made == 0
    got = prob.solve(x0, check_every=check_every, **kw)
    again = prob.solve(x0, check_every=check_every, **kw)
    assert _Replay.made == 1 and len(graphed) == 1
    (entry,) = graphed.values()
    assert entry.graph.replays == 2 * -(-eager.nit_internal // check_every) - 1
    assert got.status == rj.status == 1
    assert (got.nit, got.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    _same_result(got, eager)
    _same_result(again, eager)


@pytest.mark.parametrize("how", ["max_iter 37", "resume", "fails at 3 trials"])
def test_backtracking_stops_resumes_and_fails_bitwise(graphed, how):
    """The carried trials stopped at a ``max_iter`` that is no multiple of
    the chunk (status 0), a solve resumed from ``initial_state`` mid-run,
    and a line search exhausted at ``max_backtrack_iter=3`` (status 2: nit
    frozen, its trials counted): each bitwise the ``check_every=1`` solve
    and equal in nit and nit_internal to JAX x64."""
    A, b = _steep_lasso()
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, LAM, device="cpu")
    kw = dict(nesterov=True, tol=1e-6)
    if how == "max_iter 37":
        kw["max_iter"] = 37
    if how == "fails at 3 trials":
        kw["max_backtrack_iter"] = 3
    eager = _quiet(prob.solve, x0, check_every=1, **kw)
    rj = _quiet(jl.Lasso(A, b, LAM).solve, jnp.asarray(x0), **kw)
    if how == "resume":
        head = _quiet(prob.solve, x0, check_every=8, max_iter=50, **kw)
        assert head.status == 0 and head.nit == 50
        got = prob.solve(x0, check_every=8, initial_state=head.state, **kw)
    else:
        got = _quiet(prob.solve, x0, check_every=8, **kw)
    assert _Replay.made == (2 if how == "resume" else 1)  # max_iter is baked in
    status = {"max_iter 37": 0, "resume": 1, "fails at 3 trials": 2}[how]
    assert got.status == rj.status == status
    assert (got.nit, got.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    _same_result(got, eager)
    if how == "fails at 3 trials":
        assert (got.nit, got.nit_internal) == (0, 3) and not np.any(got.x)


def _jos1(n=20):
    ratios, shifts = [1.0 / n, 2.0 / n], [0.0, -1.0]
    x0 = np.random.default_rng(42).uniform(-2.0, 4.0, size=n)
    return (JOS1(n_features=n, l1_ratios=ratios, l1_shifts=shifts),
            JJOS1(n_features=n, l1_ratios=ratios, l1_shifts=shifts), x0)


@pytest.mark.parametrize(
    "opts",
    [{}, {"warm_start": True}, {"deprecated": True}, {"tol_internal_rel": 1e-6}],
    ids=["plain", "warm_start", "deprecated", "tol_internal_rel"],
)
def test_jos1_m2_backtracking_graphed_matches_jax_and_eager(graphed, opts):
    """JOS1 (n=20, its l1 terms) at m = 2, backtracking from lr 1 by 0.5
    (the bisection carried through rejected trials, ``w`` with
    ``warm_start``), chunks of 8: bitwise its ``check_every=1`` solve;
    equal nit and nit_internal, x within 1e-8 of JAX x64 (the m = 2
    class).  A repeat solve on the instance replays."""
    prob, jprob, x0 = _jos1()
    kw = dict(nesterov=True, tol=1e-6, lr=20.0, **opts)
    rj = _quiet(jprob.solve, jnp.asarray(x0), **kw)
    eager = _quiet(prob.solve, torch.tensor(x0), check_every=1, **kw)
    assert eager.nit_internal > 2 * eager.nit  # bisection steps and retries
    got = _quiet(prob.solve, torch.tensor(x0), check_every=8, **kw)
    again = _quiet(prob.solve, torch.tensor(x0), check_every=8, **kw)
    assert _Replay.made == 1 and len(graphed) == 1
    assert got.status == rj.status == 1
    assert (got.nit, got.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    _same_result(got, eager)
    _same_result(again, eager)


@pytest.mark.parametrize("option, value", [("decay_rate", 0.6), ("max_backtrack_iter", 50)])
def test_graph_key_separates_the_search_options(graphed, option, value):
    """Two carried searches that differ only in ``decay_rate`` or
    ``max_backtrack_iter`` never share a graph: the keys differ, and each
    solve captures its own graph and is bitwise its ``check_every=1``
    solve."""
    A, b = _steep_lasso()
    _, base, state, owners = _facade_parts(A, b, 100)
    _, other, _, _ = _facade_parts(A, b, 100, **{option: value})
    carry = solver._Search.start(state)
    key_a, _ = solver._graph_key(base.carried_search, carry, 8, owners)
    key_b, _ = solver._graph_key(other.carried_search, carry, 8, owners)
    assert key_a != key_b and base.carried_search.options[:-2] == other.carried_search.options[:-2]
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, LAM, device="cpu")
    for kw in ({}, {option: value}):
        ref = prob.solve(x0, nesterov=True, tol=1e-6, check_every=1, **kw)
        got = prob.solve(x0, nesterov=True, tol=1e-6, check_every=8, **kw)
        _same_result(got, ref)
    assert _Replay.made == 2 and len(graphed) == 2


def test_default_check_every_rule():
    """``check_every=None`` picks 64 on a card for an m = 1 fixed step, and
    1 for an m = 1 backtracking solve (on a card a first solve with its
    64-trial capture measured slower than the host loop), on the CPU, for
    m = 2 and m >= 3, and where something reads every iteration.  At
    ``check_every > 1`` a backtracking step at m <= 2 has a carried
    search; a feature-sharded one, an m >= 3 one and a verbose one do
    not."""
    rule = solver._default_check_every
    assert rule("cuda", 1, 1, per_iteration=False) == 64
    assert rule("cuda", 1, 0.5, per_iteration=False) == 1
    assert rule("cpu", 1, 1, per_iteration=False) == 1
    assert rule("cuda", 1, 1, per_iteration=True) == 1
    assert rule("cuda", 2, 1, per_iteration=False) == rule("cuda", 3, 1, per_iteration=False) == 1
    A, b = _steep_lasso()
    _, step, _, _ = _facade_parts(A, b, 100)
    _, sharded, _, _ = _facade_parts(A, b, 100, feature_sum=lambda v: v, feature_max=lambda v: v)
    _, verbose, _, _ = _facade_parts(A, b, 100, verbose=True)
    assert step.carried_search.capturable
    assert not hasattr(sharded, "carried_search") and not hasattr(verbose, "carried_search")
    f2 = lambda x: torch.stack([torch.sum(x * x), torch.sum((x - 1) ** 2)])  # noqa: E731
    g2 = lambda x: torch.zeros(2, dtype=x.dtype)  # noqa: E731
    j2 = lambda x: torch.stack([2 * x, 2 * (x - 1)])  # noqa: E731
    f3 = lambda x: torch.stack([torch.sum(x * x)] * 3)  # noqa: E731
    g3 = lambda x: torch.zeros(3, dtype=x.dtype)  # noqa: E731
    j3 = lambda x: torch.stack([2 * x] * 3)  # noqa: E731
    opts = dict(tol=1e-6, tol_internal=1e-12, max_iter_internal=100, max_backtrack_iter=10,
                warm_start=False, decay_rate=0.5, nesterov=True, nesterov_ratio=(0, 0.25),
                deprecated=False, max_iter=10)
    assert solver._make_step(f2, g2, j2, lambda w, x: x, 2, **opts).carried_search.capturable
    assert not hasattr(solver._make_step(f3, g3, j3, lambda w, x: x, 3, **opts), "carried_search")


@pytest.mark.parametrize("pair", ["shared", "per lane"])
def test_batch_fixed_lr_chunk_graphed_is_bitwise(graphed, pair):
    """The batch's fixed-lr step (a 16-lane elastic-net lambda sweep) runs
    its ``check_every=8`` chunks as replayed graphs, every field of every
    lane bitwise the ``check_every=1`` batch, with one momentum pair for
    every lane and with a per-lane ``(B, 2)`` pair (an owner of the graph,
    not a baked option)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 64)) / np.sqrt(40)
    b = rng.standard_normal(40)
    fns = make_lasso_lambda_sweep(torch.tensor(A), torch.tensor(b), l2_ratio=0.1)
    lams = torch.tensor(np.logspace(-3, 0, 16))
    x0s = torch.zeros((16, 64), dtype=F64)
    ab = None
    if pair == "per lane":
        ab = np.stack([np.linspace(0.0, 0.1, 16), np.full(16, 0.25)], axis=1)
    kw = dict(batch_params=lams, lr=1 / (2 * np.linalg.norm(A, 2) ** 2), decay_rate=1,
              nesterov=True, tol=1e-8, max_iter=3000, batch_nesterov_ratio=ab)
    ref = minimize_proximal_gradient_batch(*fns, x0s, check_every=1, **kw)
    got = minimize_proximal_gradient_batch(*fns, x0s, check_every=8, **kw)
    assert np.all(ref.status == 1) and _Replay.made == 1
    (entry,) = graphed.values()
    assert entry.graph.replays == -(-int(np.max(ref.nit)) // 8) - 1
    options = next(iter(graphed))[0]
    assert options[:2] == ("batch", "lanes" if ab is not None else 0.0)
    _bitwise(got.state, ref.state)
