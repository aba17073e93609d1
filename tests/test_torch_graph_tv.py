"""The TV solves and the m = 2 fixed step as replayed CUDA graphs, on the CPU.

With the stand-in graph of tests/test_torch_graph.py (its "capture" runs
the chunk and restores the static carry, its replay runs the chunk with
the launch counters held) and graphs allowed on the CPU, the graphed
driver runs its own logic on small float64 problems:

* ``TVDeblur.solve`` (the generic fixed step with the TV prox) graphed
  against its eager ``check_every=1`` solve, bitwise, and against the JAX
  package's ``TVDeblur.solve`` in x64, stopped by tol and by a
  ``max_iter`` that is not a multiple of the chunk;
* ``solve_warm`` (the warm-dual driver) graphed, bitwise its eager run and
  within the JAX parity tolerance; a repeat solve replays;
* JOS1 at m = 2 and ``decay_rate=1``, graphed, bitwise eager and against
  JAX x64; a repeat solve on the instance replays (its callables are bound
  methods);
* the FGP wrappers' launch counts through replays, ``_sweeps`` refusing a
  cache miss inside a capture, and the graph key separating two generic
  steps that differ in one baked option.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import _Replay, _bitwise, _quiet, graphed  # noqa: F401

from zfista_tpu.models import JOS1 as JJOS1
from zfista_tpu.models import deblur as jd
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import JOS1, TVDeblur
from zfista_tpu_torch.models import deblur as td
from zfista_tpu_torch.ops import tv_cuda

F64 = torch.float64


def _scene(size=32, seed=0, noise=0.01):
    """tests/test_torch_deblur.py's scene: two flat blocks, Gaussian 9x9
    sigma=2, numpy noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size))
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
    img[size // 2 :, : size // 2] = 0.5
    kernel = jd.gaussian_kernel(9, 2.0)
    observed = np.array(jd.make_blur(kernel)(jnp.asarray(img)))
    observed += noise * rng.standard_normal(observed.shape)
    return observed, kernel


@pytest.fixture
def fgp_counted(monkeypatch):
    """``tv_cuda.fgp`` bumping ``launch_counts["fgp_resident"]`` once per
    call, as the whole-image kernel's wrapper does on a card (the CPU path
    counts nothing)."""
    real = tv_cuda.fgp

    def counting(*args, **kwargs):
        tv_cuda.launch_counts["fgp_resident"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tv_cuda, "fgp", counting)
    monkeypatch.setattr(tv_cuda, "launch_counts", dict.fromkeys(tv_cuda.launch_counts, 0))
    return tv_cuda.launch_counts


@pytest.mark.parametrize(
    "stop, tol, max_iter", [("tol", 1e-4, 3000), ("max_iter 101", 0.0, 101)]
)
def test_tv_solve_graphed_matches_jax_and_eager(graphed, stop, tol, max_iter):
    """``TVDeblur.solve`` at 32x32 (30 dual iterations a prox call, the
    plain loop, as ``prox_method="auto"`` runs on a CPU image) at chunks
    of 8: every State field bitwise the eager ``check_every=1`` solve; equal
    nit and x within 1e-9 of JAX x64 (``test_torch_deblur``'s tolerance).
    A repeat solve on the instance replays the cached graph."""
    observed, kernel = _scene(seed=1)
    lr = 1.0 / jd.blur_lipschitz(kernel, observed.shape)
    kw = dict(tv_ratio=1e-3, kernel=kernel, prox_iter=30)
    run = dict(lr=lr, tol=tol, max_iter=max_iter)
    rj = _quiet(jd.TVDeblur(observed, prox_method="xla", **kw).solve, **run)
    prob = TVDeblur(observed, device="cpu", **kw)
    eager = _quiet(prob.solve, check_every=1, **run)
    assert _Replay.made == 0
    got = _quiet(prob.solve, check_every=8, **run)
    again = _quiet(prob.solve, check_every=8, **run)
    assert _Replay.made == 1 and len(graphed) == 1
    (entry,) = graphed.values()
    assert entry.graph.replays == 2 * -(-got.nit // 8) - 1  # the first chunk ran eagerly
    assert got.status == rj.status == (1 if stop == "tol" else 0)
    assert got.nit == rj.nit and got.nit % 8
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    _bitwise(got.state, eager.state)
    _bitwise(again.state, eager.state)


def test_tv_solve_launch_counts_through_replays(graphed, fgp_counted):
    """One FGP launch per step run, replays included: a 100-step solve at
    chunks of 8 runs 104 steps (the last chunk's frozen ones too) and
    counts 104 launches; the capture adds none, and the entry records 8
    a replay."""
    observed, kernel = _scene(size=24, seed=2)
    prob = TVDeblur(observed, device="cpu", tv_ratio=1e-3, kernel=kernel, prox_iter=10)
    res = _quiet(prob.solve, tol=0, max_iter=100, check_every=8)
    assert res.nit == 100 and fgp_counted["fgp_resident"] == 104
    (entry,) = graphed.values()
    assert entry.launches["fgp_resident"] == 8
    assert entry.launches["lasso_step_tail"] == entry.launches["fgp_tiles"] == 0


@pytest.mark.parametrize("seed, tol", [(0, 1e-4), (1, 1e-3)])
def test_solve_warm_graphed_matches_jax_and_eager(graphed, monkeypatch, seed, tol):
    """``solve_warm`` at 32x32, 8 dual iterations a prox call, its driver
    at chunks of 8 (the card's default is 64): bitwise the eager
    ``check_every=1`` run in x, F, nit and err; against JAX's
    ``solve_warm`` at ``test_solve_warm_matches_jax``'s tolerance.  A
    repeat solve on the instance replays: one capture in two solves."""
    observed, kernel = _scene(seed=seed)
    kw = dict(tv_ratio=1e-3, kernel=kernel)
    run = dict(max_iter=1000, tol=tol, prox_iter=8)
    wj = jd.TVDeblur(observed, **kw).solve_warm(**run)
    prob = TVDeblur(observed, device="cpu", **kw)
    eager = prob.solve_warm(**run)
    assert _Replay.made == 0
    monkeypatch.setattr(td, "_tv_warm_driver", functools.partial(td._tv_warm_driver, check_every=8))
    got = prob.solve_warm(**run)
    again = prob.solve_warm(**run)
    assert _Replay.made == 1 and len(graphed) == 1
    (entry,) = graphed.values()
    assert entry.graph.replays == 2 * -(-got["nit"] // 8) - 1 > 0
    for r in (got, again):
        assert r["nit"] == eager["nit"] == wj["nit"] < 1000
        assert np.array_equal(r["x"], eager["x"])
        assert r["fun"] == eager["fun"] and r["error_criterion"] == eager["error_criterion"]
    np.testing.assert_allclose(got["x"], wj["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["fun"], wj["fun"], rtol=1e-12)


def test_solve_warm_driver_graphed_stops_at_max_iter(graphed):
    """The warm-dual driver at a ``max_iter`` that is not a multiple of the
    chunk, tol 0: the graphed carry is bitwise the eager one, dual field
    included."""
    observed, kernel = _scene(size=24, seed=3)
    prob = TVDeblur(observed, device="cpu", tv_ratio=1e-3, kernel=kernel)
    Gr, Gc = prob._bands()
    args = (prob.b, Gr, Gc, *prob._warm_scalars(0.0), 37, 6, True)
    ref = td._tv_warm_driver(*args, check_every=1)
    got = td._tv_warm_driver(*args, check_every=8)
    assert _Replay.made == 1 and int(got[2]) == 37
    for a, c in zip((*ref[:4], *ref[4]), (*got[:4], *got[4])):
        assert a.dtype == c.dtype and torch.equal(a, c)


def _jos1_x0(n):
    return np.random.default_rng(42).uniform(-2.0, 4.0, size=n)


@pytest.mark.parametrize("stop", ["tol at lr 1/(10L)", "max_iter 101 at lr 1/L"])
def test_jos1_m2_fixed_step_graphed_matches_jax_and_eager(graphed, stop):
    """JOS1 (n=20, L1) at m = 2, ``decay_rate=1``, Nesterov, chunks of 8:
    bitwise its eager ``check_every=1`` solve in every State field; equal
    nit and nit_internal and x within 1e-8 of JAX x64 (the m = 2 class).
    A repeat solve on the same instance replays the cached graph."""
    n = 20
    ratios, shifts = [1.0 / n, 2.0 / n], [0.0, -1.0]
    lr = n / 2 * (0.1 if stop.startswith("tol") else 1.0)  # L = 2/n
    run = dict(decay_rate=1, lr=lr, nesterov=True)
    run.update(dict(tol=1e-5, max_iter=1000) if stop.startswith("tol") else dict(tol=0, max_iter=101))
    x0 = _jos1_x0(n)
    rj = _quiet(JJOS1(n_features=n, l1_ratios=ratios, l1_shifts=shifts).solve,
                jnp.asarray(x0), check_every=8, **run)
    prob = JOS1(n_features=n, l1_ratios=ratios, l1_shifts=shifts)
    eager = _quiet(prob.solve, torch.tensor(x0), check_every=1, **run)
    got = _quiet(prob.solve, torch.tensor(x0), check_every=8, **run)
    again = _quiet(prob.solve, torch.tensor(x0), check_every=8, **run)
    assert _Replay.made == 1 and len(graphed) == 1
    (entry,) = graphed.values()
    assert entry.graph.replays == 2 * -(-got.nit // 8) - 1 > 0
    assert got.status == rj.status == (1 if stop.startswith("tol") else 0)
    assert (got.nit, got.nit_internal) == (rj.nit, rj.nit_internal) and got.nit % 8
    np.testing.assert_allclose(got.x, np.asarray(rj.x), rtol=0, atol=1e-8)
    _bitwise(got.state, eager.state)
    _bitwise(again.state, eager.state)


def test_sweeps_cache_miss_inside_a_capture_raises(monkeypatch):
    """The tile sweeps' start values are read on the host once per
    ``(n_iter, dtype, device)``: a read that would happen inside a capture
    raises, a cached one is returned."""
    dev = torch.device("cpu")
    cached = tv_cuda._sweeps(19, F64, dev)
    monkeypatch.setattr(tv_cuda, "_SWEEPS", dict(tv_cuda._SWEEPS))
    monkeypatch.setattr(tv_cuda, "_capturing", lambda: True)
    assert tv_cuda._sweeps(19, F64, dev) == cached
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        tv_cuda._sweeps(23, F64, dev)
    assert (23, F64, dev, tv_cuda.HALO) not in tv_cuda._SWEEPS


_BASE = dict(
    tol=1e-6, tol_rel=0.0, tol_internal=1e-12, tol_internal_rel=0.0, max_iter_internal=100,
    warm_start=False, nesterov=True, nesterov_ratio=(0.0, 0.25), deprecated=False,
    adaptive_restart=False, project_momentum=False, track_objective=True, max_iter=100,
)


@pytest.mark.parametrize(
    "option, value",
    [("tol", 1e-7), ("tol_rel", 1e-6), ("tol_internal", 1e-11), ("tol_internal_rel", 1e-3),
     ("max_iter_internal", 50), ("warm_start", True), ("nesterov", False),
     ("nesterov_ratio", (0.5, 0.25)), ("deprecated", True), ("adaptive_restart", True),
     ("project_momentum", True), ("track_objective", False), ("max_iter", 101), ("m", 2)],
)
def test_graph_key_separates_each_baked_option(option, value):
    """Two generic fixed steps that differ in one option they bake in never
    share a chunk graph: their keys differ, with the same owners and
    carry."""
    f = lambda x: torch.stack([torch.sum(x * x), torch.sum((x - 1) ** 2)])  # noqa: E731
    jac = lambda x: torch.stack([2 * x, 2 * (x - 1)])  # noqa: E731
    g = lambda x: torch.zeros(2, dtype=x.dtype)  # noqa: E731
    prox = lambda w, x: x  # noqa: E731

    def step(m=1, **kw):
        opts = dict(_BASE, **kw)
        fm = (lambda x: f(x)[:1]) if m == 1 else f
        jm = (lambda x: jac(x)[:1]) if m == 1 else jac
        gm = (lambda x: g(x)[:1]) if m == 1 else g
        return solver._make_step(fm, gm, jm, prox, m, max_backtrack_iter=10, decay_rate=1,
                                 **opts)

    x0 = torch.zeros(4, dtype=F64)
    state = solver.init_state(x0, torch.zeros(1, dtype=F64), 1, torch.tensor(0.1, dtype=F64))
    owners = (f, g, jac, prox)
    base = step()
    other = step(m=value) if option == "m" else step(**{option: value})
    assert base.capturable and other.capturable and base.options != other.options
    key_a, _ = solver._graph_key(base, state, 8, owners)
    key_b, _ = solver._graph_key(other, state, 8, owners)
    assert key_a != key_b
    assert solver._graph_key(step(), state, 8, owners)[0] == key_a
