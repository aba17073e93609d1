"""The port's Haar DWT pair and WaveletDeblur against the JAX package's,
float64 on the CPU.

* ``dwt2``/``idwt2`` against JAX at every level, sides 8-64; the round
  trip, the adjoint identity, out-of-place and ``torch.func.vmap``;
* ``WaveletDeblur``'s pieces against JAX, with the reference's Gaussian,
  a non-symmetric separable kernel and a non-separable one;
* the fixed-step solve through the fused-step seam (its tail's plain
  version on the CPU): equal nit and x to 1e-10 at lambda 1e-3; at the
  reference's lambda 2e-5 the trajectory amplifies rounding (JAX against
  itself from a start changed by 1e-15 parts: 1.7e-13 after 200
  iterations, 6e-4 after 800), so there the first 200 iterations are held;
* the seam's solve equal to the same solve with an unmarked prox;
* a 3-pair momentum sweep at 16x16 against the JAX sweep;
* validation, ``model_from_jax``, and the card by default.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.bench import momentum_sweep as jm
from zfista_tpu.models import deblur as jd
from zfista_tpu_torch import interop
from zfista_tpu_torch.bench import momentum_sweep as tm
from zfista_tpu_torch.core.solver import minimize_proximal_gradient
from zfista_tpu_torch.models import WaveletDeblur
from zfista_tpu_torch.models import deblur as td

F64 = torch.float64


def _kernels():
    rng = np.random.default_rng(11)
    taps = np.array([0.2, 0.3, 0.5])
    k_conv = rng.random((3, 3))
    return {
        "gauss9_4": jd.gaussian_kernel(9, 4.0),
        "separable_nonsymmetric": np.outer(taps, taps),
        "conv_nonsymmetric": k_conv / k_conv.sum(),
    }


def _pair(size, kernel, l1_ratio, levels=None):
    img = np.asarray(jd.synthetic_cameraman(size))
    observed = np.asarray(jd.make_blur(kernel)(jnp.asarray(img)))
    j = jd.WaveletDeblur(jnp.asarray(observed), l1_ratio=l1_ratio, kernel=kernel, levels=levels)
    t = WaveletDeblur(torch.tensor(observed), l1_ratio=l1_ratio, kernel=kernel, levels=levels)
    return j, t


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


@pytest.mark.parametrize("side", [8, 16, 32, 64])
def test_dwt_pair_matches_jax_at_every_level(side):
    rng = np.random.default_rng(side)
    for levels in range(int(np.log2(side)) + 1):
        x = rng.standard_normal((side, side))
        for fn_t, fn_j in ((td.dwt2, jd.dwt2), (td.idwt2, jd.idwt2)):
            got = fn_t(torch.tensor(x), levels).numpy()
            np.testing.assert_allclose(got, np.asarray(fn_j(jnp.asarray(x), levels)),
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("levels", [0, 1, 3, 5])
def test_round_trip_and_adjoint(levels):
    rng = np.random.default_rng(levels)
    x = torch.tensor(rng.standard_normal((32, 32)))
    y = torch.tensor(rng.standard_normal((32, 32)))
    x_in = x.clone()
    np.testing.assert_allclose(td.idwt2(td.dwt2(x, levels), levels).numpy(), x.numpy(),
                               rtol=0, atol=1e-12)
    assert torch.equal(x, x_in)  # out of place
    lhs = float(torch.sum(td.dwt2(x, levels) * y))
    rhs = float(torch.sum(x * td.idwt2(y, levels)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    assert torch.equal(td.idwt2(x, 0), x) and torch.equal(td.dwt2(x, 0), x)


def test_dwt_pair_under_vmap():
    x = torch.tensor(np.random.default_rng(1).standard_normal((3, 16, 16)))
    for fn in (td.dwt2, td.idwt2):
        lanes = torch.func.vmap(lambda v: fn(v, 4))(x)
        for i in range(3):
            assert torch.equal(lanes[i], fn(x[i], 4))


@pytest.mark.parametrize("name", sorted(_kernels()))
def test_model_pieces_match_jax(name):
    j, t = _pair(16, _kernels()[name], 2e-5)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(j.n_features)
    for piece in ("f", "jac_f", "g"):
        got = getattr(t, piece)(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(j, piece)(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(t.prox_wsum_g(0.3, torch.tensor(x)).numpy(),
                                  np.asarray(j.prox_wsum_g(0.3, jnp.asarray(x))))
    np.testing.assert_allclose(t.x0().numpy(), np.asarray(j.x0()), rtol=0, atol=1e-12)
    assert t.lipschitz() == j.lipschitz()
    assert (t.levels, t.n_features, t.n_objectives) == (j.levels, j.n_features, j.n_objectives)
    # the gradient is the TRUE adjoint one: autodiff of f agrees
    xt = torch.tensor(x)
    ad = torch.func.grad(lambda z: t.f(z)[0])(xt)
    np.testing.assert_allclose(t.jac_f(xt)[0].numpy(), ad.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", sorted(_kernels()))
def test_fixed_step_solve_matches_jax(name):
    j, t = _pair(32, _kernels()[name], 1e-3)
    rj = j.solve(tol=1e-6, max_iter=3000)
    rt = t.solve(tol=1e-6, max_iter=3000)
    assert rt.status == rj.status == 1
    assert rt.nit == rj.nit
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-10)


def test_reference_lambda_window_matches_jax():
    """lambda 2e-5 (the reference's): the first 200 iterations agree."""
    j, t = _pair(32, jd.gaussian_kernel(9, 4.0), 2e-5)
    rj = j.solve(tol=0, max_iter=200)
    rt = _quiet(t.solve, tol=0, max_iter=200)
    assert rt.nit == rj.nit == 200
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("separable", [True, False])
def test_seam_solve_equals_unmarked_prox(monkeypatch, separable):
    """The marked prox runs the fused step tail (its plain version here);
    the same callables with an unmarked prox run the generic step.  Same
    iterates, bitwise."""
    kernel = jd.gaussian_kernel(5, 1.0) if separable else _kernels()["conv_nonsymmetric"]
    _, t = _pair(16, kernel, 1e-3)
    res = _quiet(t.solve, tol=0, max_iter=150)
    f_p, g_p, jac_p, prox_p = td._wavelet_callables(t.levels, separable)
    assert (len(t._params) == 4) == separable
    unmarked = lambda w, x, p: prox_p(w, x, p)  # noqa: E731
    ref = _quiet(
        minimize_proximal_gradient, f_p, g_p, jac_p, unmarked, t.x0(), params=t._params,
        lr=1.0 / t.lipschitz(), decay_rate=1, nesterov=True, tol=0, max_iter=150,
    )
    assert res.nit == ref.nit == 150
    for name, a, b in zip(res.state._fields, res.state, ref.state):
        if name not in ("F_x", "sub_fun"):  # the fused tail never computes F
            np.testing.assert_array_equal(a, b, err_msg=name)
    # the marked prox did take the fused tail
    from zfista_tpu_torch.core import solver

    calls = []
    real = solver.lasso_step_tail
    monkeypatch.setattr(solver, "lasso_step_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    _quiet(t.solve, tol=0, max_iter=7)
    assert len(calls) == 7


def test_solve_defaults_and_given_x0():
    _, t = _pair(16, jd.gaussian_kernel(5, 1.0), 1e-3)
    res = _quiet(t.solve, max_iter=3)
    assert res.lr == 1.0 / t.lipschitz()
    given = _quiet(t.solve, max_iter=3, x0=np.zeros(t.n_features, np.float32), lr=0.25)
    assert given.lr == 0.25 and given.x.dtype == np.float64


def test_momentum_sweep_matches_jax():
    """Three momentum pairs at 16x16 as one batched sweep: lane nits equal
    to the JAX sweep's."""
    kernel = jd.gaussian_kernel(5, 1.0)
    j, t = _pair(16, kernel, 1e-3)
    kw = dict(n_starts=1, ab_grid=tm.AB_GRID[:3], measure_times=False, nesterov=True,
              lr=1.0 / t.lipschitz(), decay_rate=1, tol=1e-6, max_iter=2000, check_every=8)
    rows_j, res_j = jm.momentum_sweep(j, 0.0, 0.0, x0s=np.asarray(j.x0())[None, :], **kw)
    rows_t, res_t = tm.momentum_sweep(t, 0.0, 0.0, x0s=t.x0().numpy()[None, :], device="cpu",
                                      **kw)
    np.testing.assert_array_equal(res_t.nit, np.asarray(res_j.nit))
    assert [r["nit"] for r in rows_t] == [r["nit"] for r in rows_j]
    np.testing.assert_allclose(res_t.x, np.asarray(res_j.x), rtol=0, atol=1e-10)


def test_validation_errors():
    with pytest.raises(ValueError, match="2-D"):
        WaveletDeblur(torch.zeros(16, dtype=F64))
    with pytest.raises(ValueError, match="power-of-two"):
        WaveletDeblur(torch.zeros((16, 8), dtype=F64))
    with pytest.raises(ValueError, match="power-of-two"):
        WaveletDeblur(torch.zeros((12, 12), dtype=F64))
    for levels in (0, 5):
        with pytest.raises(ValueError, match="levels"):
            WaveletDeblur(torch.zeros((16, 16), dtype=F64), levels=levels)
    assert WaveletDeblur(torch.zeros((16, 16), dtype=F64), levels=2).levels == 2


def test_model_from_jax_round_trip():
    j, _ = _pair(16, _kernels()["separable_nonsymmetric"], 1e-3, levels=3)
    t = interop.model_from_jax(j, device="cpu")
    assert isinstance(t, WaveletDeblur) and t.levels == 3 and t.l1_ratio == 1e-3
    assert t.b.device.type == "cpu" and t.b.dtype == F64
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    x = np.random.default_rng(2).standard_normal(j.n_features)
    np.testing.assert_allclose(t.jac_f(torch.tensor(x)).numpy(),
                               np.asarray(j.jac_f(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="no port"):
        interop.model_from_jax(jax.numpy.zeros(3), device="cpu")


def test_goes_to_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveletDeblur(np.zeros((8, 8)))
    assert WaveletDeblur(np.zeros((8, 8)), device="cpu").b.device.type == "cpu"
