"""The port's SparseLogistic against the JAX package's, float64 on the CPU.

* ``f``/``jac_f`` at margins up to +-40 (``torch.nn.functional.softplus``
  returns its input above 20, so it would fail here) and their autodiff;
* the backtracking and fixed-step solves: equal nit and trial counts, x to
  1e-10; the fixed step through the fused-step seam (its tail's plain
  version on the CPU); ``kkt_residual``;
* the integer ``A`` cast, the label check, ``model_from_jax``, and the
  card by default.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models.logistic import SparseLogistic as JLogistic
from zfista_tpu_torch import interop
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import SparseLogistic
from zfista_tpu_torch.models import logistic as tl

F64 = torch.float64


def _data(n=60, d=12, seed=0):
    """tests/test_logistic.py's toy: 3 informative features, noisy labels."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d))
    w = np.zeros(d)
    w[:3] = [1.5, -2.0, 1.0]
    y = np.sign(A @ w + 0.3 * rng.standard_normal(n))
    return A, y


def _pair(l1_ratio=0.02, **kw):
    A, y = _data(**kw)
    return JLogistic(A, y, l1_ratio), SparseLogistic(A, y, l1_ratio, device="cpu")


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0, 40.0])
def test_f_and_jac_match_jax_at_large_margins(scale):
    j, t = _pair()
    rng = np.random.default_rng(int(scale))
    x = rng.standard_normal(j.n_features)
    x *= scale / np.max(np.abs(j.A @ x))  # the largest margin is +-scale
    np.testing.assert_allclose(t.f(torch.tensor(x)).numpy(), np.asarray(j.f(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(t.jac_f(torch.tensor(x)).numpy(),
                               np.asarray(j.jac_f(jnp.asarray(x))), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(t.g(torch.tensor(x)).numpy(), np.asarray(j.g(jnp.asarray(x))),
                               rtol=1e-14)
    np.testing.assert_array_equal(t.prox_wsum_g(0.7, torch.tensor(x)).numpy(),
                                  np.asarray(j.prox_wsum_g(0.7, jnp.asarray(x))))
    ad = torch.func.grad(lambda z: t.f(z))(torch.tensor(x))
    np.testing.assert_allclose(t.jac_f(torch.tensor(x)).numpy(), ad.numpy(), rtol=1e-8,
                               atol=1e-14)


def test_softplus_is_exact_past_the_torch_threshold():
    z = torch.tensor([-50.0, -20.5, 0.0, 20.5, 30.0, 50.0], dtype=F64)
    ref = np.logaddexp(z.numpy(), 0.0)
    np.testing.assert_allclose(tl._softplus(z).numpy(), ref, rtol=1e-15, atol=0)
    # the default F.softplus returns z itself past its threshold 20
    assert float(torch.nn.functional.softplus(z)[4]) == 30.0
    assert float(tl._softplus(z)[4]) != 30.0


@pytest.mark.parametrize("seed", [0, 1])
def test_backtracking_solve_matches_jax(seed):
    j, t = _pair(seed=seed)
    rj = j.solve(tol=1e-10)
    rt = t.solve(tol=1e-10)
    assert rt.status == rj.status == 1
    assert (rt.nit, rt.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    assert t.kkt_residual(rt.x) < 1e-6
    assert t.kkt_residual(rt.x) == pytest.approx(j.kkt_residual(np.asarray(rj.x)), abs=1e-12)


def test_fixed_step_solve_matches_jax_through_the_seam(monkeypatch):
    j, t = _pair()
    L = j.lipschitz()
    calls = []
    real = solver.lasso_step_tail
    monkeypatch.setattr(solver, "lasso_step_tail",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rj = j.solve(lr=1.0 / L, decay_rate=1, tol=1e-8)
    rt = t.solve(lr=1.0 / L, decay_rate=1, tol=1e-8)
    assert rt.status == rj.status == 1 and rt.nit == rj.nit
    assert len(calls) == rt.nit  # one step tail per step (check_every 1 on the CPU)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    # backtracking starts above 1/L and settles on a larger step
    bt = t.solve(lr=16.0 / L, tol=1e-8)
    assert bt.nit < rt.nit and bt.lr > 1.0 / L


def test_kkt_residual_matches_jax():
    j, t = _pair()
    rng = np.random.default_rng(4)
    for x in (np.zeros(j.n_features), rng.standard_normal(j.n_features),
              np.where(rng.random(j.n_features) < 0.5, 0.0, rng.standard_normal(j.n_features))):
        assert t.kkt_residual(x) == pytest.approx(j.kkt_residual(jnp.asarray(x)), rel=1e-12)


def test_lipschitz_bound():
    j, t = _pair()
    assert t.lipschitz(n_iter=200) == pytest.approx(j.lipschitz(n_iter=200), rel=1e-10)
    A, _ = _data()
    assert t.lipschitz(n_iter=200) == pytest.approx(
        np.linalg.norm(A, 2) ** 2 / (4 * A.shape[0]), rel=1e-10
    )


def test_integer_A_and_labels():
    A, y = _data()
    Ai = np.round(3 * A).astype(np.int64)
    t = SparseLogistic(Ai, y, 0.05, device="cpu")
    assert t.A.dtype == torch.get_default_dtype() and t._params[2].item() == pytest.approx(0.05)
    j = JLogistic(Ai, y, 0.05)
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    np.testing.assert_allclose(t.f(torch.tensor(x, dtype=t.A.dtype)).numpy(),
                               np.asarray(j.f(jnp.asarray(x))), rtol=1e-6)
    for bad in (np.zeros_like(y), np.where(y > 0, 2.0, -1.0)):
        with pytest.raises(ValueError, match="-1/\\+1"):
            SparseLogistic(A, bad, device="cpu")


def test_model_from_jax_round_trip():
    j, _ = _pair()
    t = interop.model_from_jax(j, device="cpu")
    assert isinstance(t, SparseLogistic) and t.l1_ratio == j.l1_ratio
    np.testing.assert_array_equal(t.A.numpy(), np.asarray(j.A))
    np.testing.assert_array_equal(t.y.numpy(), np.asarray(j.y))
    rt, rj = t.solve(tol=1e-8), j.solve(tol=1e-8)
    assert rt.nit == rj.nit


def test_goes_to_the_card_by_default(monkeypatch):
    A, y = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseLogistic(A, y)
    assert SparseLogistic(A, y, device="cpu").A.device.type == "cpu"
