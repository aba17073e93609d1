"""The port's fixed-step solver vs the JAX package's, float64 on the CPU.

The slice end to end (``Lasso.solve_fixed_step``), one step continued from
a JAX ``State`` carried across with ``interop``, ``check_every`` chunking
(bitwise within the port), and the closed-form toy of
tests/test_solver_scalar.py.  The backtracking and multiobjective options
are in tests/test_torch_multi.py.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models import lasso as jl
from zfista_tpu_torch import SolverOptions, interop, minimize_proximal_gradient
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import Lasso
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.ops.prox import soft_threshold

F64 = torch.float64


def _lasso(seed, m=40, n=120, k=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    lr = 1.0 / (2 * np.linalg.norm(A, 2) ** 2)
    return A, b, lr


def _quiet(fn, *args, **kwargs):
    """Run a solve whose max_iter cap is the point (status 0 warns)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


@pytest.mark.parametrize(
    "seed, opts",
    [
        (0, {}),
        (1, {}),
        (2, {}),
        (3, {"tol_rel": 1e-6}),
        (4, {"nesterov": False}),
    ],
)
def test_slice_matches_jax(seed, opts):
    """Same explicit lr on both sides (their power iterations draw different
    start vectors): exact nit, x at 1e-9, fun at 1e-12."""
    A, b, lr = _lasso(seed)
    x0 = np.zeros(A.shape[1])
    kw = dict(lr=lr, tol=1e-8, **opts)
    rj = jl.Lasso(A, b, 0.05).solve_fixed_step(x0, **kw)
    rt = Lasso(A, b, 0.05, device="cpu").solve_fixed_step(x0, **kw)
    assert rj.status == 1
    assert rt.nit == rj.nit
    assert (rt.status, rt.success, rt.message) == (rj.status, rj.success, rj.message)
    assert rt.nit_internal == rj.nit_internal
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-12)
    assert isinstance(rt.x, np.ndarray) and rt.x.dtype == np.float64
    assert rt.lr == lr
    assert rt.error_criterion == pytest.approx(rj.error_criterion, rel=0, abs=1e-11)


def _port_step(A, b, lam, n, max_iter=None):
    p = interop.lasso_params_from_numpy(A, b, lam, device="cpu")
    bound = solver._bind_params(
        tl._lasso_f_p, tl._lasso_g_p, tl._lasso_jac_p, tl._lasso_prox_p, p
    )
    fv, gv, jv, pv, m, _ = solver._normalize_problem(
        *bound, torch.zeros(n, dtype=F64)
    )
    step = solver._make_step(
        fv, gv, jv, pv, m, tol=1e-8, tol_internal=1e-12,
        max_iter_internal=100000, max_backtrack_iter=100, warm_start=False,
        decay_rate=1, nesterov=True, nesterov_ratio=(0, 0.25),
        deprecated=False, track_objective=False, max_iter=max_iter,
    )
    return step, fv, gv


@pytest.mark.parametrize("k", [1, 5, 37])
def test_one_port_step_continues_a_jax_state(k):
    A, b, lr = _lasso(5)
    n = A.shape[1]
    x0 = np.zeros(n)
    prob = jl.Lasso(A, b, 0.05)
    sk = _quiet(prob.solve_fixed_step, x0, lr=lr, tol=1e-8, max_iter=k).state
    sk1 = _quiet(prob.solve_fixed_step, x0, lr=lr, tol=1e-8, max_iter=k + 1).state
    state = interop.state_from_numpy(sk, device="cpu")
    back = interop.state_to_numpy(state)
    for a, c in zip(back, sk):
        assert np.array_equal(a, np.asarray(c)) and a.dtype == np.asarray(c).dtype

    step, fv, gv = _port_step(A, b, 0.05, n)
    new = step(state)
    new = new._replace(F_x=fv(new.x) + gv(new.x))  # JAX recomputes F at the end
    for name, got, ref in zip(solver.State._fields, interop.state_to_numpy(new), sk1):
        np.testing.assert_allclose(
            got, np.asarray(ref), rtol=1e-12, atol=1e-12, err_msg=name
        )
        assert got.dtype == np.asarray(ref).dtype, name


@pytest.mark.parametrize("stop", ["converged", "max_iter"])
def test_check_every_chunks_are_bitwise(stop):
    A, b, lr = _lasso(6)
    x0 = np.zeros(A.shape[1])
    if stop == "converged":
        kw = dict(lr=lr, tol=1e-8)
    else:
        kw = dict(lr=lr, tol=0, max_iter=101)
    runs = {
        ce: _quiet(Lasso(A, b, 0.05, device="cpu").solve_fixed_step, x0, check_every=ce, **kw)
        for ce in (1, 7, 64)
    }
    ref = runs[1]
    assert ref.status == (1 if stop == "converged" else 0)
    for ce in (7, 64):
        assert runs[ce].nit == ref.nit
        for name, a, c in zip(solver.State._fields, ref.state, runs[ce].state):
            assert np.array_equal(a, c), (ce, name)


def _toy(l1_ratio):
    """tests/test_solver_scalar.py's 1-D LASSO toy, in torch."""
    A = torch.tensor([[-1.0], [0.0], [1.0]], dtype=F64)
    b = torch.tensor([-1.0, 0.0, 1.0], dtype=F64)

    def f(x):
        r = A @ x - b
        return torch.dot(r, r) / 6

    def g(x):
        return l1_ratio * torch.sum(torch.abs(x))

    def jac_f(x):
        return A.T @ (A @ x - b) / 3

    def prox_wsum_g(weight, x):
        return soft_threshold(x, l1_ratio * weight)

    return f, g, jac_f, prox_wsum_g


@pytest.mark.parametrize("autodiff", [False, True])
def test_fixed_lr_closed_form(autodiff):
    """decay_rate=1, lr=1/L=1.5: x* = 1 - 3*0.1/2 = 0.85."""
    f, g, jac_f, prox = _toy(0.1)
    res = minimize_proximal_gradient(
        f, g, None if autodiff else jac_f, prox, np.array([0.3]),
        lr=1.5, decay_rate=1, nesterov=True, device="cpu",
    )
    assert res.success and res.status == 1
    np.testing.assert_array_almost_equal(res.x, [0.85], decimal=3)
    assert np.ndim(res.fun) == 0  # scalar objective stays scalar
    for field in ("x", "fun", "success", "status", "message", "nit",
                  "nit_internal", "time", "weight", "state"):
        assert field in res, field


def test_solver_options_drive_the_facade():
    f, g, jac_f, prox = _toy(0.1)
    opts = SolverOptions(lr=1.5, decay_rate=1, nesterov=True, tol=1e-9)
    res = minimize_proximal_gradient(
        f, g, jac_f, prox, np.array([0.3]), device="cpu", **opts.kwargs()
    )
    np.testing.assert_allclose(res.x, [0.85], atol=1e-8)
    assert opts.replace(tol=1e-3).tol == 1e-3 and opts.tol == 1e-9


def _counting(monkeypatch, name):
    calls = []
    real = getattr(solver, name)

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(solver, name, counting)
    return calls


def test_lasso_step_goes_through_the_fused_wrapper(monkeypatch):
    """The params-style Lasso prox reaches the fused step tail, once per
    step and with no other fused call; the same problem through the Lasso
    methods composes prox and momentum.  On the CPU both are the same
    arithmetic, so the results are bitwise equal."""
    tails = _counting(monkeypatch, "lasso_step_tail")
    firsts = _counting(monkeypatch, "fused_prox_momentum")
    A, b, lr = _lasso(7)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    fused_res = prob.solve_fixed_step(x0, lr=lr, tol=1e-8)
    assert len(tails) == fused_res.nit and firsts == []
    tails.clear()
    composed = minimize_proximal_gradient(
        prob.f, prob.g, prob.jac_f, prob.prox_wsum_g,
        torch.zeros(A.shape[1], dtype=F64),
        lr=lr, tol=1e-8, decay_rate=1, nesterov=True,
    )
    assert tails == [] and firsts == []
    assert composed.nit == fused_res.nit
    assert np.array_equal(composed.x, fused_res.x)


@pytest.mark.parametrize("opts", [{"tol_rel": 1e-6}, {"warm_start": True}])
def test_options_the_tail_kernel_does_not_take_are_routed(monkeypatch, opts):
    """tol_rel and warm_start keep the step's tail in eager launches around
    the kernel's first entry (one call per step), and still match JAX:
    exact nit, x at 1e-10."""
    tails = _counting(monkeypatch, "lasso_step_tail")
    firsts = _counting(monkeypatch, "fused_prox_momentum")
    A, b, lr = _lasso(11)
    x0 = np.zeros(A.shape[1])
    kw = dict(lr=lr, tol=1e-8, **opts)
    rt = Lasso(A, b, 0.05, device="cpu").solve_fixed_step(x0, **kw)
    assert tails == [] and len(firsts) == rt.nit
    rj = jl.Lasso(A, b, 0.05).solve_fixed_step(x0, **kw)
    assert rt.nit == rj.nit and rt.status == rj.status == 1
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.weight, np.asarray(rj.weight), rtol=0, atol=0)


@pytest.mark.parametrize("check_every", [1, 8, 64])
@pytest.mark.parametrize("seed", [12, 13])
def test_fused_tail_solve_matches_jax_state(seed, check_every):
    """The fixed-step LASSO solve through the self-masking step tail against
    JAX x64: exact nit, x within 1e-10, every State field equal (floats at
    1e-10, counters and flags exactly)."""
    A, b, lr = _lasso(seed)
    x0 = np.zeros(A.shape[1])
    kw = dict(lr=lr, tol=1e-8)
    rj = jl.Lasso(A, b, 0.05).solve_fixed_step(x0, **kw)
    rt = Lasso(A, b, 0.05, device="cpu").solve_fixed_step(x0, check_every=check_every, **kw)
    assert rt.nit == rj.nit and rt.nit_internal == rj.nit_internal
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    for name, got, ref in zip(solver.State._fields, rt.state, rj.state):
        ref = np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10, err_msg=name)
        else:
            assert np.array_equal(got, ref), name


def _composed_solve(A, b, lam, **kw):
    """The same solve through the Lasso methods: no fused seam, so the
    generic branch composes the tail and ``_masked`` masks it."""
    prob = Lasso(A, b, lam, device="cpu")
    return _quiet(
        minimize_proximal_gradient, prob.f, prob.g, prob.jac_f, prob.prox_wsum_g,
        kw.pop("x0"), decay_rate=1, nesterov=True, **kw,
    )


@pytest.mark.parametrize("check_every", [1, 8, 64])
@pytest.mark.parametrize("stop", ["converges mid-chunk", "max_iter mid-chunk", "NaN"])
def test_self_masking_step_is_bitwise_the_masked_step(stop, check_every):
    """The step tail masks itself: a chunk of it equals, field for field and
    bit for bit, the chunk of ``_masked`` composed steps, on states that
    converge mid-chunk, reach max_iter mid-chunk, and carry NaN."""
    A, b, lr = _lasso(14)
    x0 = torch.zeros(A.shape[1], dtype=F64)
    kw = dict(lr=lr, tol=1e-8, check_every=check_every)
    if stop == "max_iter mid-chunk":
        kw.update(tol=0, max_iter=21)
    elif stop == "NaN":
        x0[3] = float("nan")
        kw.update(max_iter=13)
    got = _quiet(Lasso(A, b, 0.05, device="cpu").solve_fixed_step, x0, **kw)
    ref = _composed_solve(A, b, 0.05, x0=x0, **kw)
    if stop == "converges mid-chunk":
        assert got.status == 1 and got.nit % 64 and got.nit % 8
    else:
        assert got.status == 0 and got.nit == kw["max_iter"]
    if stop == "NaN":
        assert np.isnan(got.error_criterion) and np.isnan(got.x).any()
    for name, a, c in zip(solver.State._fields, got.state, ref.state):
        assert a.dtype == c.dtype and np.array_equal(a, c, equal_nan=True), name


@pytest.mark.parametrize("reason", ["converged", "failed", "max_iter"])
def test_step_tail_passes_a_stopped_state_through(reason):
    """A state that is not active comes back value for value (NaN too),
    in fresh tensors, from the plain tail and hence from the step."""
    A, b, lr = _lasso(15)
    n = A.shape[1]
    step, _, _ = _port_step(A, b, 0.05, n, max_iter=9)
    assert step.masks_itself
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal(n))
    y = torch.from_numpy(rng.standard_normal(n))
    y[0] = float("nan")
    state = solver.init_state(x, torch.zeros(1, dtype=F64), 1, torch.tensor(lr, dtype=F64))
    state = state._replace(
        y=y, t=torch.tensor(2.5, dtype=F64), err=torch.tensor(float("nan"), dtype=F64),
        nit=torch.tensor(9 if reason == "max_iter" else 4, dtype=torch.int32),
        nit_internal=torch.tensor(4, dtype=torch.int32),
        converged=torch.tensor(reason == "converged"),
        failed=torch.tensor(reason == "failed"),
    )
    new = step(state)
    for name, a, c in zip(solver.State._fields, new, state):
        assert a.dtype == c.dtype, name
        assert np.array_equal(a.numpy(), c.numpy(), equal_nan=True), name
    # An active state with the same fields does move.
    live = state._replace(
        nit=torch.tensor(4, dtype=torch.int32), converged=torch.tensor(False),
        failed=torch.tensor(False),
    )
    assert int(step(live).nit) == 5


@pytest.mark.parametrize("how", ["iter_chunk", "initial_state"])
def test_fused_tail_chunks_and_resumes_bitwise(how):
    """``iter_chunk`` (the host-chunked loop runs the self-masking step
    unmasked) and an ``initial_state`` continuation give bitwise the
    uninterrupted solve."""
    A, b, lr = _lasso(16)
    x0 = np.zeros(A.shape[1])
    prob = Lasso(A, b, 0.05, device="cpu")
    ref = prob.solve_fixed_step(x0, lr=lr, tol=1e-8, check_every=1)
    if how == "iter_chunk":
        got = prob.solve_fixed_step(x0, lr=lr, tol=1e-8, iter_chunk=7)
    else:
        part = _quiet(prob.solve_fixed_step, x0, lr=lr, tol=1e-8, max_iter=ref.nit // 2)
        got = prob.solve_fixed_step(x0, lr=lr, tol=1e-8, initial_state=part.state, check_every=8)
    assert got.nit == ref.nit and got.status == 1
    for name, a, c in zip(solver.State._fields, got.state, ref.state):
        assert np.array_equal(a, c), name


def test_invalid_arguments_raise():
    f, g, jac_f, prox = _toy(0.1)
    with pytest.raises(ValueError, match="check_every"):
        minimize_proximal_gradient(
            f, g, jac_f, prox, np.array([0.3]), decay_rate=1, check_every=0
        )
    with pytest.raises(ValueError, match="tol_rel"):
        minimize_proximal_gradient(
            f, g, jac_f, prox, np.array([0.3]), decay_rate=1, tol_rel=-1
        )


def test_jax_and_port_states_share_a_layout():
    """interop relies on the two State types listing the same 12 fields."""
    from zfista_tpu.core.solver import State as JaxState

    assert solver.State._fields == JaxState._fields
    assert len(solver.State._fields) == 12
    # A port State converted to numpy rebuilds a JAX State directly.
    A, b, lr = _lasso(8)
    res = Lasso(A, b, 0.05, device="cpu").solve_fixed_step(np.zeros(A.shape[1]), lr=lr, tol=1e-6)
    js = JaxState(*(jnp.asarray(v) for v in res.state))
    assert int(js.nit) == res.nit


@pytest.mark.parametrize("entry", ["facade", "lasso", "tv_deblur", "problem"])
def test_entry_points_put_numpy_data_on_the_card(entry, monkeypatch):
    """Data given as numpy goes to ``device="cuda"`` by default: with no
    card that raises (nothing falls back to the CPU); ``device="cpu"``
    asks for the CPU, and a CPU tensor keeps its device."""
    from zfista_tpu_torch.models import JOS1, TVDeblur

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, g, jac_f, prox = _toy(0.1)
    A, b, lr = _lasso(9)
    img = np.random.default_rng(9).standard_normal((12, 10))
    x0 = np.array([0.3])
    calls = {
        "facade": lambda **kw: minimize_proximal_gradient(
            f, g, jac_f, prox, x0, lr=1.5, decay_rate=1, **kw
        ),
        "lasso": lambda **kw: Lasso(A, b, 0.05, **kw).A,
        "tv_deblur": lambda **kw: TVDeblur(img, **kw).b,
        "problem": lambda **kw: JOS1(n_features=3).solve(
            np.full(3, 0.5), max_iter=3, **kw
        ),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    x = out if isinstance(out, torch.Tensor) else torch.as_tensor(out.x)
    assert x.device.type == "cpu"
    if entry == "facade":
        res = minimize_proximal_gradient(
            f, g, jac_f, prox, torch.tensor([0.3], dtype=F64), lr=1.5, decay_rate=1
        )
        assert res.success
