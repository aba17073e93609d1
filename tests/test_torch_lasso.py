"""The port's LASSO model vs the JAX package's, float64 on the CPU.

Same numpy inputs through ``zfista_tpu.models.lasso`` and
``zfista_tpu_torch.models.lasso``; the two differ only in the summation
order of their matvecs, so values agree at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models import lasso as jl
from zfista_tpu_torch import interop
from zfista_tpu_torch.models import Lasso
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.ops import fused

RTOL, ATOL = 1e-12, 1e-12


def _problem(seed, m=40, n=120):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = rng.standard_normal(m)
    x = rng.standard_normal(n)
    return A, b, x


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_lasso_methods_match_jax(l2):
    A, b, x = _problem(0)
    jp = jl.Lasso(A, b, 0.05, l2)
    tp = Lasso(A, b, 0.05, l2, device="cpu")
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(tp.f(xt), jp.f(xj))
    _close(tp.jac_f(xt), jp.jac_f(xj))
    _close(tp.g(xt), jp.g(xj))
    for w in (0.0, 0.7, 3.0):
        wt = torch.tensor(w, dtype=torch.float64)
        _close(tp.prox_wsum_g(wt, xt), jp.prox_wsum_g(w, xj))


@pytest.mark.parametrize("l2", [None, 0.3])
def test_params_callables_match_jax(l2):
    A, b, x = _problem(1)
    jparams = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(0.05))
    if l2 is not None:
        jparams = jparams + (jnp.asarray(l2),)
    tparams = interop.lasso_params_from_numpy(A, b, 0.05, l2, device="cpu")
    assert all(v.dtype == torch.float64 for v in tparams)
    assert len(tparams) == len(jparams)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(tl._lasso_f_p(xt, tparams), jl._lasso_f_p(xj, jparams))
    _close(tl._lasso_jac_p(xt, tparams), jl._lasso_jac_p(xj, jparams))
    _close(tl._lasso_g_p(xt, tparams), jl._lasso_g_p(xj, jparams))
    w = np.array([0.4])
    _close(
        tl._lasso_prox_p(torch.from_numpy(w), xt, tparams),
        jl._lasso_prox_p(jnp.asarray(w), xj, jparams),
    )


def test_fista_step_dense_matches_jax():
    A, b, x = _problem(2)
    y = np.random.default_rng(3).standard_normal(A.shape[1])
    f64 = torch.float64
    ref = jl.fista_step_dense(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(0.02), jnp.asarray(0.05),
        (jnp.asarray(x), jnp.asarray(y), jnp.asarray(1.7)),
    )
    got = tl.fista_step_dense(
        torch.from_numpy(A), torch.from_numpy(b), torch.tensor(0.02, dtype=f64),
        torch.tensor(0.05, dtype=f64),
        (torch.from_numpy(x), torch.from_numpy(y), torch.tensor(1.7, dtype=f64)),
    )
    for t, j in zip(got, ref):
        _close(t, j)


@pytest.mark.parametrize("steps", [1, 6])
def test_fused_dense_step_matches_jax_and_the_plain_step(steps):
    """The raw loop over the fused dense step (the raw tail computes t+,
    gamma and the threshold itself) against the JAX dense step, and
    bitwise the port's plain step on the CPU."""
    A, b, x = _problem(4)
    f64 = torch.float64
    args_j = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(0.02), jnp.asarray(0.05))
    args_t = (
        torch.from_numpy(A), torch.from_numpy(b), torch.tensor(0.02, dtype=f64),
        torch.tensor(0.05, dtype=f64),
    )
    cj = (jnp.asarray(x), jnp.asarray(x), jnp.asarray(1.0))
    ct = cp = (torch.from_numpy(x), torch.from_numpy(x), torch.tensor(1.0, dtype=f64))
    for _ in range(steps):
        cj = jl.fista_step_dense(*args_j, cj)
        ct = fused.fista_step_dense_fused(*args_t, ct)
        cp = tl.fista_step_dense(*args_t, cp)
    for t, j, q in zip(ct, cj, cp):
        _close(t, j)
        assert torch.equal(t, q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operator_norm_sq_matches_numpy(seed):
    A, _, _ = _problem(seed)
    At = torch.from_numpy(A)
    ref = np.linalg.norm(A, 2) ** 2
    # Converged: the top two eigenvalues of AᵀA here differ by >= 3%, so
    # 500 power steps shrink the error below 1e-12 relative.
    np.testing.assert_allclose(float(tl.operator_norm_sq(At, 500)), ref, rtol=1e-12)
    # The default 50 steps: a Rayleigh quotient, never above λ_max, within
    # 2% on these matrices (the JAX estimate is off by up to 1.7% too).
    est = float(tl.operator_norm_sq(At))
    assert ref * (1 - 2e-2) <= est <= ref * (1 + 1e-12)
    # The start vector comes from an explicit generator.
    g = torch.Generator().manual_seed(5)
    assert float(tl.operator_norm_sq(At, 500, g)) == pytest.approx(ref, rel=1e-12)


def test_operator_norm_sq_takes_the_jax_seed():
    """The JAX signature ``operator_norm_sq(A, n_iter=50, seed=0)``: both
    call forms run, seeds 0 and 1 draw different start vectors (0 steps:
    the start's Rayleigh quotient), and from either 500 steps reach
    ``‖A‖₂²`` at 1e-12; a generator by keyword wins over the seed."""
    A, _, _ = _problem(3)
    At = torch.from_numpy(A)
    ref = np.linalg.norm(A, 2) ** 2
    jax_ref = float(jl.operator_norm_sq(jnp.asarray(A), 500, 0))
    positional = float(tl.operator_norm_sq(At, 50, 0))
    assert positional == float(tl.operator_norm_sq(At, seed=0)) == float(tl.operator_norm_sq(At))
    assert ref * (1 - 2e-2) <= positional <= ref * (1 + 1e-12)
    starts = {s: float(tl.operator_norm_sq(At, 0, s)) for s in (0, 1)}
    assert starts[0] != starts[1]
    for s in (0, 1):
        np.testing.assert_allclose(float(tl.operator_norm_sq(At, 500, seed=s)), ref, rtol=1e-12)
    np.testing.assert_allclose(jax_ref, ref, rtol=1e-12)
    g = torch.Generator().manual_seed(1)
    assert float(tl.operator_norm_sq(At, 0, 0, generator=g)) == starts[1]


def test_lipschitz_and_integer_operator():
    A, b, _ = _problem(0)
    prob = Lasso(A, b, 0.05, 0.3, device="cpu")
    L = 2 * np.linalg.norm(A, 2) ** 2 + 0.3
    assert prob.lipschitz(500) == pytest.approx(L, rel=1e-12)
    # An integer operator is promoted, so λ is not truncated to 0.
    iprob = Lasso(np.ones((3, 2), np.int64), np.ones(3), 0.5, device="cpu")
    assert iprob.A.is_floating_point() and iprob.b.dtype == iprob.A.dtype
