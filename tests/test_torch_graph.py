"""The fixed-step solve's chunks as replayed CUDA graphs, on the CPU.

There is no card here, so no graph is captured: the graph factory
``solver.CHUNK_GRAPH`` is swapped for a stand-in that does what a capture
and a replay do to the program's state.  Its "capture" runs the chunk (so
the launch wrappers count what a capture would record) and puts the static
buffers back as they were (a capture computes nothing); its replay runs
the chunk with the launch counters held (a replay runs no wrapper).  With
it, and graphs allowed on the CPU, the driver's own logic runs: the static
carry, one host read per chunk, the eager first chunk on a cache miss, the
cache, the launch counts.

* the graphed driver bitwise ``run_masked`` at ``check_every=1``, for
  chunks of 1, 7 and 64, converging and stopping at a ``max_iter`` that
  is not a multiple of the chunk, on a small LASSO and a small wavelet
  problem, and the public solves against JAX x64 (whose facade runs
  ``make_while_driver``): equal ``nit``, x at 1e-10;
* the cache: its key, its hits, its bound of 8, the dropping of an entry
  whose params tensor died, and an in-place change of ``A`` seen;
* the generic fixed step (``tol_rel``, ``warm_start``, restart, ISTA, ...)
  graphed and bitwise its ``check_every=1`` solve; the steps and routes
  that are not capturable never reach the graph path (backtracking at
  m <= 2 and the fixed-lr batch are graphed:
  tests/test_torch_graph_backtracking.py; m >= 3 solves:
  tests/test_torch_graph_newton.py);
* the launch counters count replayed launches;
* a host scalar inside a capture raises.

tests/test_torch_graph_tv.py does the same for the TV solves and the
m = 2 fixed step, with this file's stand-in.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import gc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models import deblur as jd
from zfista_tpu.models import lasso as jl
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import FDS, Lasso, SparseLogistic, WaveletDeblur
from zfista_tpu_torch.models import deblur as td
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.ops import fused, tv_cuda

F64 = torch.float64


class _Replay:
    """Stands in for a CUDA graph of ``chunk(static)`` on the CPU."""

    made = 0

    def __init__(self, chunk, static, stream):
        assert stream is None  # the CPU has no streams
        _Replay.made += 1
        self.chunk, self.static = chunk, static
        saved = [v.clone() for v in static]
        chunk(static)  # the wrappers run once, as at a capture ...
        for s, v in zip(static, saved):
            s.copy_(v)  # ... which computes nothing
        self.replays = 0

    def replay(self):
        counters = (fused.launch_counts, tv_cuda.launch_counts)
        held = [dict(c) for c in counters]
        self.chunk(self.static)
        for c, h in zip(counters, held):
            c.update(h)  # a replay runs no wrapper
        self.replays += 1


@pytest.fixture
def graphed(monkeypatch):
    """Chunks on the CPU through the stand-in, from an empty cache."""
    monkeypatch.setattr(solver, "CHUNK_GRAPH", _Replay)
    monkeypatch.setattr(solver, "_graphs_run_on", lambda device: True)
    monkeypatch.setattr(solver, "_GRAPHS", solver.OrderedDict())
    _Replay.made = 0
    return solver._GRAPHS


@pytest.fixture
def counted(monkeypatch):
    """``lasso_step_tail`` bumping ``fused.launch_counts`` as the CUDA
    wrapper does (the CPU path counts nothing)."""
    real = solver.lasso_step_tail

    def counting(*args, **kwargs):
        fused.launch_counts["lasso_step_tail"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(solver, "lasso_step_tail", counting)
    monkeypatch.setattr(fused, "launch_counts", dict.fromkeys(fused.launch_counts, 0))
    return fused.launch_counts


def _quiet(fn, *args, **kwargs):
    """Run a solve whose max_iter cap is the point (status 0 warns)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


def _lasso(seed, m=40, n=120, k=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    lr = 1.0 / (2 * np.linalg.norm(A, 2) ** 2)
    return A, b, lr


def _wavelet(l1_ratio=1e-3, side=32):
    kernel = jd.gaussian_kernel(9, 4.0)
    img = np.asarray(jd.synthetic_cameraman(side))
    observed = np.asarray(jd.make_blur(kernel)(jnp.asarray(img)))
    j = jd.WaveletDeblur(jnp.asarray(observed), l1_ratio=l1_ratio, kernel=kernel)
    t = WaveletDeblur(torch.tensor(observed), l1_ratio=l1_ratio, kernel=kernel)
    return j, t


def _bitwise(got, ref):
    for name, a, c in zip(solver.State._fields, got, ref):
        a, c = np.asarray(a), np.asarray(c)
        assert a.dtype == c.dtype and np.array_equal(a, c, equal_nan=True), name


def _step_and_state(problem, max_iter, tol, **step_kw):
    """The facade's fixed-step step for ``problem`` ("lasso" or "wavelet"),
    its start state, and the owners the facade keys a graph by; ``step_kw``
    go to ``_make_step``."""
    if problem == "lasso":
        A, b, lr = _lasso(3)
        p = (torch.tensor(A), torch.tensor(b), torch.tensor(0.05, dtype=F64))
        fns = (tl._lasso_f_p, tl._lasso_g_p, tl._lasso_jac_p, tl._lasso_prox_p)
        x0 = torch.zeros(A.shape[1], dtype=F64)
    else:
        _, t = _wavelet()
        p = td._blur_params(t.b, t.kernel, t.l1_ratio, td._band_pair(t.kernel, t.b))
        fns = td._wavelet_callables(t.levels, separable=True)
        lr = 1.0 / t.lipschitz()
        x0 = t.x0()
    bound = solver._bind_params(*fns, p)
    fv, gv, jv, pv, m, _ = solver._normalize_problem(*bound, x0)
    step = solver._make_step(
        fv, gv, jv, pv, m, tol=tol, tol_internal=1e-12, max_iter_internal=100000,
        max_backtrack_iter=100, warm_start=False, decay_rate=1, nesterov=True,
        nesterov_ratio=(0, 0.25), deprecated=False, track_objective=False,
        max_iter=max_iter, **step_kw,
    )
    state = solver.init_state(x0, fv(x0) + gv(x0), m, torch.tensor(lr, dtype=F64))
    return step, state, (*fns, *p)


@pytest.mark.parametrize("problem", ["lasso", "wavelet"])
@pytest.mark.parametrize("stop", ["converges", "max_iter 101"])
def test_graphed_driver_is_bitwise_run_masked(graphed, problem, stop):
    """``run_graphed`` at chunks of 1, 7 and 64 against ``run_masked`` at
    ``check_every=1``: every State field, bit for bit, nit included."""
    max_iter, tol = (100_000, 1e-6) if stop == "converges" else (101, 0.0)
    step, state, owners = _step_and_state(problem, max_iter, tol)
    assert step.capturable and step.masks_itself
    active = lambda s: solver._active(s, max_iter)  # noqa: E731
    ref = solver.run_masked(step, state, active, 1)
    if stop == "converges":
        assert bool(ref.converged) and int(ref.nit) % 7 and int(ref.nit) % 64
    else:
        assert int(ref.nit) == 101 and not bool(ref.converged)
    for ce in (1, 7, 64):
        made = _Replay.made
        got = solver.run_graphed(step, state, active, ce, owners)
        _bitwise(got, ref)
        assert _Replay.made == made + 1  # a new chunk length, a new graph
        entry = next(reversed(graphed.values()))
        chunks = -(-int(ref.nit) // ce)
        assert entry.graph.replays == chunks - 1  # the first chunk ran eagerly
    # The input state is left as it was (the driver works on its copy).
    assert int(state.nit) == 0


@pytest.mark.parametrize("check_every", [7, 64])
@pytest.mark.parametrize("seed", [12, 13])
def test_graphed_lasso_solve_matches_jax_and_eager(graphed, seed, check_every):
    """The public fixed-step LASSO solve, graphed: equal nit and x within
    1e-10 of JAX x64 (its ``make_while_driver`` at the same chunk), every
    State field bitwise the port's eager ``check_every=1`` solve."""
    A, b, lr = _lasso(seed)
    x0 = np.zeros(A.shape[1])
    kw = dict(lr=lr, tol=1e-8)
    rj = jl.Lasso(A, b, 0.05).solve_fixed_step(x0, check_every=check_every, **kw)
    prob = Lasso(A, b, 0.05, device="cpu")
    eager = prob.solve_fixed_step(x0, check_every=1, **kw)
    assert _Replay.made == 0
    rt = prob.solve_fixed_step(x0, check_every=check_every, **kw)
    assert _Replay.made == 1 and len(graphed) == 1
    assert rt.status == rj.status == 1
    assert rt.nit == rj.nit and rt.nit_internal == rj.nit_internal
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    _bitwise(rt.state, eager.state)
    # A repeat solve on the frozen instance replays the cached graph.
    again = prob.solve_fixed_step(x0, check_every=check_every, **kw)
    assert _Replay.made == 1
    _bitwise(again.state, eager.state)


def test_graphed_wavelet_solve_matches_jax_and_eager(graphed):
    """The fixed-step ``WaveletDeblur.solve`` at 32x32, lambda 1e-3,
    graphed: equal nit and x within 1e-10 of JAX x64, bitwise the port's
    eager ``check_every=1`` solve."""
    j, t = _wavelet()
    rj = j.solve(tol=1e-6, max_iter=3000, check_every=8)
    eager = t.solve(tol=1e-6, max_iter=3000, check_every=1)
    rt = t.solve(tol=1e-6, max_iter=3000, check_every=8)
    assert _Replay.made == 1
    assert rt.status == rj.status == 1 and rt.nit == rj.nit
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    _bitwise(rt.state, eager.state)


def test_graphed_logistic_fixed_step_is_bitwise_eager(graphed):
    """The fixed-step ``SparseLogistic.solve`` runs graphed, bitwise its
    ``check_every=1`` solve."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((60, 40))
    y = np.sign(A @ rng.standard_normal(40) + 0.1 * rng.standard_normal(60))
    prob = SparseLogistic(torch.tensor(A), torch.tensor(y), 0.01)
    lr = 1.0 / prob.lipschitz()
    kw = dict(decay_rate=1, lr=lr, tol=1e-8, max_iter=5000)
    eager = prob.solve(check_every=1, **kw)
    got = prob.solve(check_every=16, **kw)
    assert _Replay.made == 1 and eager.status == 1
    _bitwise(got.state, eager.state)


def test_cache_key_hits_bound_and_eviction(graphed):
    """Entries are keyed by the baked options and the params' identity: a
    repeat solve hits, another chunk, tol, max_iter or operator misses;
    at most ``GRAPH_CACHE_SIZE`` entries are kept, least recently used out
    first; an entry whose params tensor died is dropped."""
    A, b, lr = _lasso(20)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    kw = dict(lr=lr, tol=0)
    _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=40, **kw)
    _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=40, **kw)
    assert len(graphed) == 1 and _Replay.made == 1
    (key,) = graphed
    assert key[0] == (0.0, 0.25, 0.0, 40) and key[1] == 8
    _quiet(prob.solve_fixed_step, x0, check_every=4, max_iter=40, **kw)
    _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=41, **kw)
    _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=40, lr=lr, tol=1e-30)
    assert len(graphed) == 4 and _Replay.made == 4
    # The bound: the oldest entries go first, a hit refreshes its entry.
    first, second = list(graphed)[:2]
    for it in range(50, 56):
        _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=it, **kw)
        if it == 50:
            _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=40, **kw)
    assert len(graphed) == solver.GRAPH_CACHE_SIZE == 8 and _Replay.made == 10
    assert first in graphed and second not in graphed  # refreshed by its hit, it stayed
    # Another instance on the same arrays: new tensors, a new entry ...
    other = Lasso(A, b, 0.05, device="cpu")
    _quiet(other.solve_fixed_step, x0, check_every=8, max_iter=40, **kw)
    other_key = next(reversed(graphed))
    assert _Replay.made == 11 and other_key != first
    graphed[other_key].graph.chunk = None  # a real graph keeps no Python object
    # ... dropped at the next lookup once its params tensors died.
    del other
    gc.collect()
    _quiet(prob.solve_fixed_step, x0, check_every=8, max_iter=40, **kw)
    assert other_key not in graphed and len(graphed) == 7 and _Replay.made == 11


def test_in_place_change_of_the_operator_is_seen(graphed):
    """The graph reads the params by pointer: after ``A.mul_`` a cached
    graph's solve equals an eager solve on the changed operator."""
    A, b, lr = _lasso(21)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    kw = dict(lr=lr, tol=1e-8, check_every=8)
    prob.solve_fixed_step(x0, **kw)
    prob.A.mul_(0.9)
    got = prob.solve_fixed_step(x0, **kw)
    assert _Replay.made == 1
    changed = Lasso(prob.A.clone(), b, 0.05, device="cpu")
    ref = changed.solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=1)
    _bitwise(got.state, ref.state)


@pytest.mark.parametrize(
    "how",
    ["tol_rel", "warm_start", "adaptive_restart", "project_momentum", "ista", "ista+tol_rel"],
)
def test_generic_fixed_steps_are_graphed_and_bitwise(graphed, how):
    """The generic fixed step (the LASSO with ``tol_rel`` or ``warm_start``,
    which compose the tail around ``fused_prox_momentum``, and the step's
    other options, which take the generic prox branch) is capturable: its
    chunks are replayed graphs, and every State field is bitwise its
    ``check_every=1`` solve.  A repeat solve replays."""
    A, b, lr = _lasso(22)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    opts = {
        "tol_rel": dict(tol_rel=1e-6),
        "warm_start": dict(warm_start=True),
        "adaptive_restart": dict(adaptive_restart=True),
        "project_momentum": dict(project_momentum=True),
        "ista": dict(nesterov=False),
        "ista+tol_rel": dict(nesterov=False, tol_rel=1e-6),
    }[how]
    kw = dict(lr=lr, tol=1e-8, **opts)
    eager = prob.solve_fixed_step(x0, check_every=1, **kw)
    assert _Replay.made == 0 and eager.status == 1 and eager.nit > 16
    got = prob.solve_fixed_step(x0, check_every=8, **kw)
    again = prob.solve_fixed_step(x0, check_every=8, **kw)
    assert _Replay.made == 1 and len(graphed) == 1
    (entry,) = graphed.values()
    assert entry.scratch is None and entry.graph.replays >= 1
    _bitwise(got.state, eager.state)
    _bitwise(again.state, eager.state)


@pytest.mark.parametrize(
    "how",
    ["backtracking", "m>=3", "feature-sharded", "check_every=1", "one chunk", "verbose",
     "return_all", "iter_chunk", "batch"],
)
def test_steps_that_are_not_capturable_stay_eager(graphed, how, capsys):
    """A feature-sharded step (its all-reduces) is not capturable;
    ``check_every=1``, a solve of one chunk, ``verbose`` and
    ``iter_chunk`` keep the eager loop: none reaches the graph factory.
    At m >= 3 (FDS) too: a backtracking solve and a batch under
    ``iter_chunk``, a fixed-step solve and a ``return_all`` solve with
    ``verbose`` (each prints its rows).  (Backtracking at m <= 2 and the
    fixed-lr batch are graphed: tests/test_torch_graph_backtracking.py;
    the backtracking batch at m <= 2, the history drivers and
    ``return_all`` at m <= 2: tests/test_torch_graph_history.py; every
    m >= 3 solve, batch and history otherwise:
    tests/test_torch_graph_newton.py.)"""
    A, b, lr = _lasso(22)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    fixed = dict(lr=lr, tol=1e-8, check_every=8)

    def sharded():
        # One rank's view: the reductions over features are the identity.
        step, state, owners = _step_and_state("lasso", 1000, 1e-8, feature_sum=lambda v: v,
                                              feature_max=lambda v: v)
        assert not getattr(step, "capturable", False)
        out = solver.make_while_driver(step, 1000, 8, owners)(state)
        return type("R", (), {"status": int(out.converged)})

    runs = {
        "backtracking": lambda: _quiet(FDS(n_features=10).solve, torch.zeros(10, dtype=F64),
                                       nesterov=True, check_every=8, iter_chunk=5, max_iter=12,
                                       tol=0),
        "m>=3": lambda: _quiet(FDS(n_features=10).solve, torch.zeros(10, dtype=F64),
                               decay_rate=1, lr=0.05, nesterov=True, check_every=8,
                               max_iter=40, tol=0, verbose=True),
        "feature-sharded": sharded,
        "check_every=1": lambda: prob.solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=1),
        "one chunk": lambda: _quiet(prob.solve_fixed_step, x0, lr=lr, tol=0, max_iter=8,
                                    check_every=8),
        "verbose": lambda: prob.solve_fixed_step(x0, verbose=True, **fixed),
        "return_all": lambda: _quiet(FDS(n_features=10).solve, torch.zeros(10, dtype=F64),
                                     nesterov=True, return_all=True, max_iter=12, tol=0,
                                     verbose=True),
        "iter_chunk": lambda: _quiet(prob.solve_fixed_step, x0, iter_chunk=5, **fixed),
        "batch": lambda: _quiet(FDS(n_features=10).solve_batch, torch.zeros((2, 10), dtype=F64),
                                nesterov=True, check_every=8, iter_chunk=5, max_iter=12, tol=0),
    }
    res = runs[how]()
    assert _Replay.made == 0 and len(graphed) == 0
    if how in ("m>=3", "return_all"):
        assert capsys.readouterr().out.count("\n") >= 12  # a row a step
    stopped = ("one chunk", "m>=3", "backtracking", "return_all", "batch")  # at max_iter
    assert np.all(np.asarray(res.status) == (0 if how in stopped else 1))


def test_launch_counts_count_replayed_launches(graphed, counted):
    """The eager first chunk counts through the wrapper; each replay adds
    the launches its capture recorded (one ``lasso_step_tail`` per step);
    the capture itself adds none.  A solve that stops at ``nit`` has
    launched its step ``nit`` rounded up to the chunk.  The one capture
    adds its steps and its three host timers to ``graph_counts``."""
    A, b, lr = _lasso(23)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    before = dict(solver.graph_counts)
    for k in range(2):  # a miss (eager chunk, capture, replays), then a hit
        counted["lasso_step_tail"] = 0
        res = prob.solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=7)
        assert counted["lasso_step_tail"] == -(-res.nit // 7) * 7
        assert counted["fused_prox_momentum"] == counted["fista_tail"] == 0
    (entry,) = graphed.values()
    assert entry.launches == {
        "fused_prox_momentum": 0, "fista_tail": 0, "lasso_step_tail": 7, "lasso_normal_gemv": 0,
        "fgp_resident": 0, "fgp_tiles": 0, "fgp_tiles_pipelined": 0,
    }
    grew = {k: solver.graph_counts[k] - before[k] for k in before}
    assert grew["captures"] == 1 and grew["steps"] == 7
    assert grew["first_chunk_ns"] > 0 and grew["record_ns"] > 0 and grew["instantiate_ns"] >= 0


def test_single_pass_gradient_counts_one_launch_a_graph_step(graphed, counted, monkeypatch):
    """Where the dispatch takes the single-pass gradient, it counts one
    ``lasso_normal_gemv`` launch a step, eager or replayed, beside the step
    tail's: the plain version stands in for the kernel on the CPU, bitwise
    the two products it replaces, so the solve is the same."""
    def counting(A, b, y):
        fused.launch_counts["lasso_normal_gemv"] += 1
        return fused.lasso_normal_gemv_plain(A, b, y)

    A, b, lr = _lasso(23)
    x0 = np.zeros(A.shape[1])
    ref = Lasso(A, b, 0.05, device="cpu").solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=7)
    monkeypatch.setattr(tl, "_one_pass", lambda A, b, x: True)
    monkeypatch.setattr(fused, "lasso_normal_gemv", counting)
    prob = Lasso(A, b, 0.05, device="cpu")
    for k in range(2):  # a miss (eager chunk, capture, replays), then a hit
        counted["lasso_step_tail"] = counted["lasso_normal_gemv"] = 0
        res = prob.solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=7)
        steps = -(-res.nit // 7) * 7
        assert counted["lasso_normal_gemv"] == counted["lasso_step_tail"] == steps
        _bitwise(res.state, ref.state)
    entry = next(reversed(graphed.values()))
    assert entry.launches["lasso_normal_gemv"] == entry.launches["lasso_step_tail"] == 7


def test_host_scalar_inside_a_capture_raises(monkeypatch):
    """On the captured path every scalar is already a 0-d device tensor; a
    host value there raises instead of being baked into the graph."""
    like = torch.zeros(3, device="meta")  # stands for the step's device
    lam = torch.tensor(0.5, device="meta")
    assert fused._scalar("lam", lam, like) is lam
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        fused._scalar("lam", 0.5, like)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        fused._scalar("lam", torch.tensor(0.5), like)  # on another device
    # A device value of another dtype is converted on the device.
    assert fused._scalar("lam", lam.double(), like).dtype == torch.float32


def test_only_the_fused_tail_is_marked_capturable():
    """Which steps carry the ``capturable`` mark: the fused tail (which alone
    takes the scratch words), the generic fixed step at m <= 2, the
    carried search of a backtracking step at m <= 2 and of any m >= 3 step
    (fixed or backtracking, its Newton iterations carried), the fixed-lr
    batch step at m <= 2 and the carried search of a backtracking batch
    step at m <= 2 and of any m >= 3 batch step, each with every option it
    bakes in; not the per-iteration backtracking step, a per-iteration
    m >= 3 step (its Newton loop reads the host), a verbose one, nor the
    round-based backtracking batch step, which masks itself but reads the
    host in its line search."""
    step, _, _ = _step_and_state("lasso", 10, 1e-8)
    assert step.capturable and step.takes_scratch and step.options == (0.0, 0.25, 1e-8, 10)
    f = lambda x: torch.sum(x * x)  # noqa: E731
    prox = lambda w, x: x  # noqa: E731

    def make(m=1, **kw):
        args = dict(
            tol=1e-8, tol_internal=1e-12, max_iter_internal=10, max_backtrack_iter=10,
            warm_start=False, decay_rate=0.5, nesterov=True, nesterov_ratio=(0, 0.25),
            deprecated=False, max_iter=10,
        )
        args.update(kw)
        return solver._make_step(
            lambda x: torch.stack([f(x)] * m), lambda x: torch.zeros(m, dtype=x.dtype),
            lambda x: torch.stack([2 * x] * m), prox, m, **args,
        )

    baked = (0.0, 0.25, 1e-8, 0.0)
    inner = (False, True, False, False, False, 1e-12, 0.0, 10, True, 10)
    for m in (1, 2):
        generic = make(m, decay_rate=1)
        assert generic.capturable and not getattr(generic, "takes_scratch", False)
        assert generic.options == ("step", *baked, m, *inner)
        assert not hasattr(generic, "carried_search")
        backtracking = make(m)
        assert not getattr(backtracking, "capturable", False)
        search = backtracking.carried_search
        assert search.capturable and search.masks_itself
        assert search.options == ("search", *baked, m, *inner, 0.5, 10)
    for decay, mbi in ((1, 0), (0.5, 10)):  # a fixed step takes no backtracking bound
        newton = make(3, decay_rate=decay, max_backtrack_iter=mbi)
        assert not getattr(newton, "capturable", False)
        search = newton.carried_search
        assert search.capturable and search.masks_itself
        assert search.options == ("newton search", *baked, 3, *inner, float(decay), mbi)
        assert search.start == solver._NewtonSearch.start
    for step in (make(1, decay_rate=1, verbose=True), make(1, verbose=True),
                 make(1, max_backtrack_iter=0), make(3, verbose=True),
                 make(3, decay_rate=1, verbose=True), make(3, max_backtrack_iter=0)):
        assert not getattr(step, "capturable", False) and not hasattr(step, "carried_search")

    def batch(m=1, **kw):
        args = dict(tol=1e-8, tol_internal=1e-12, max_iter_internal=10, max_backtrack_iter=10,
                    warm_start=False, nesterov=True, deprecated=False, max_iter=10)
        args.update(kw)
        return solver._make_batch_step(
            lambda x: torch.stack([f(x)] * m), lambda x: torch.zeros(m, dtype=x.dtype),
            lambda x: torch.stack([2 * x] * m), prox, m, None, **args,
        )

    fixed = batch(decay_rate=1, nesterov_ratio=(0, 0.25))
    assert fixed.masks_itself and fixed.capturable
    assert fixed.options == ("batch", *baked, 1, *inner)
    lanes = batch(decay_rate=1, nesterov_ratio=(torch.zeros(2), torch.full((2,), 0.25)))
    assert lanes.capturable and lanes.options == ("batch", "lanes", 1e-8, 0.0, 1, *inner)
    backtracking = batch(decay_rate=0.5, nesterov_ratio=(0, 0.25))
    assert backtracking.masks_itself and not getattr(backtracking, "capturable", False)
    search = backtracking.carried_search
    assert search.capturable and search.masks_itself
    assert search.options == ("batch search", *baked, 1, *inner, 0.5, 10)
    assert not hasattr(batch(decay_rate=0.5, nesterov_ratio=(0, 0.25), max_backtrack_iter=0),
                       "carried_search")
    for decay in (1, 0.5):
        newton = batch(3, decay_rate=decay, nesterov_ratio=(0, 0.25))
        assert newton.masks_itself and not getattr(newton, "capturable", False)
        search = newton.carried_search
        assert search.capturable and search.masks_itself
        assert search.options == ("batch newton search", *baked, 3, *inner, float(decay), 10)
