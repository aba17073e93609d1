"""The port's fused prox-momentum kernel vs the JAX package's, on the CPU.

Here the port's wrapper takes its plain PyTorch version (a CPU tensor
never reaches the CUDA kernel); the JAX side runs its Pallas kernel in
interpret mode and its pure-jnp reference, as tests/test_fused.py does.
The CUDA kernel itself is checked against the plain version on the card
by chip_smoke.py.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.cpp_extension

from zfista_tpu.models.lasso import fista_step_dense as jax_fista_step_dense
from zfista_tpu.ops.fused import (
    fista_step_dense_pallas,
    fused_prox_momentum_xla,
)
from zfista_tpu.ops.fused import fused_prox_momentum as jax_fused_prox_momentum
from zfista_tpu_torch.models.lasso import fista_step_dense
from zfista_tpu_torch.ops import _build, fused

# float32: 1-ULP differences allowed (tests/test_fused.py): XLA and eager
# PyTorch may contract the multiply-adds differently.  float64: the same
# allowance at float64's epsilon.
TOL = {
    np.float32: dict(rtol=2e-7, atol=1e-7),
    np.float64: dict(rtol=1e-15, atol=1e-15),
}


def _scalars(dtype):
    return tuple(dtype(v) for v in (0.1, 0.05, 0.3))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 100, 128, 1024, 5000])
def test_fused_prox_momentum_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    y, g, x = (rng.standard_normal(n).astype(dtype) for _ in range(3))
    lr, thresh, gamma = _scalars(dtype)
    xt, yt = fused.fused_prox_momentum(
        torch.from_numpy(y),
        torch.from_numpy(g),
        torch.from_numpy(x),
        torch.tensor(lr),
        torch.tensor(thresh),
        torch.tensor(gamma),
    )
    # The CPU path is the plain version, and it never counts as a launch.
    assert fused.launch_counts["fused_prox_momentum"] == 0
    assert xt.dtype == yt.dtype == torch.from_numpy(y).dtype
    jy, jg, jx = (jnp.asarray(v) for v in (y, g, x))
    for ref in (
        jax_fused_prox_momentum(jy, jg, jx, lr, thresh, gamma, interpret=True),
        fused_prox_momentum_xla(jy, jg, jx, lr, thresh, gamma),
    ):
        np.testing.assert_allclose(xt.numpy(), np.asarray(ref[0]), **TOL[dtype])
        np.testing.assert_allclose(yt.numpy(), np.asarray(ref[1]), **TOL[dtype])


def test_fused_plain_is_the_cpu_path_bitwise():
    rng = np.random.default_rng(7)
    y, g, x = (torch.from_numpy(rng.standard_normal(257)) for _ in range(3))
    got = fused.fused_prox_momentum(y, g, x, 0.1, 0.05, 0.3)
    ref = fused.fused_prox_momentum_plain(y, g, x, 0.1, 0.05, 0.3)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_fista_step_dense_fused_matches_jax_pallas_step():
    rng = np.random.default_rng(1)
    m, n = 16, 300
    A = rng.standard_normal((m, n)) / 4
    b = rng.standard_normal(m)
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)
    t, lam, lr = 1.7, 0.02, 0.01

    ref = fista_step_dense_pallas(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(lam), jnp.asarray(lr),
        (jnp.asarray(x), jnp.asarray(y), jnp.asarray(t)), interpret=True,
    )
    f64 = torch.float64
    carry = (torch.from_numpy(x), torch.from_numpy(y), torch.tensor(t, dtype=f64))
    args = (
        torch.from_numpy(A),
        torch.from_numpy(b),
        torch.tensor(lam, dtype=f64),
        torch.tensor(lr, dtype=f64),
    )
    got = fused.fista_step_dense_fused(*args, carry)
    plain = fista_step_dense(*args, carry)
    for r, p, q in zip(ref, got, plain):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-13, atol=1e-14)
        # On the CPU the fused step is the plain step, bitwise.
        assert torch.equal(p, q)


def _dense_problem(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m, n = 16, 300
    A = (rng.standard_normal((m, n)) / 4).astype(dtype)
    b = rng.standard_normal(m).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    y = rng.standard_normal(n).astype(dtype)
    return A, b, x, y


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_fista_tail_matches_the_jax_dense_steps(seed):
    """The raw tail (t-update, thresh and gamma computed inside) on the
    numpy gradient against both JAX dense steps: the Pallas one in
    interpret mode and the plain one."""
    A, b, x, y = _dense_problem(seed)
    t, lam, lr = 1.0 + seed, 0.02, 0.01
    grad = 2 * (A.T @ (A @ y - b))
    f64 = torch.float64
    got = fused.fista_tail(
        torch.from_numpy(y), torch.from_numpy(grad), torch.from_numpy(x),
        torch.tensor(t, dtype=f64), torch.tensor(lr, dtype=f64), torch.tensor(lam, dtype=f64),
    )
    assert fused.launch_counts["fista_tail"] == 0  # the CPU path never counts
    args = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(lam), jnp.asarray(lr))
    carry = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    for ref in (
        fista_step_dense_pallas(*args, carry, interpret=True),
        jax_fista_step_dense(*args, carry),
    ):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_fused_loop_matches_jax(dtype):
    """Five fused dense steps in a row against five JAX Pallas steps
    (interpret mode): the carry handed on, t included."""
    A, b, x, _ = _dense_problem(5, dtype)
    lam, lr = dtype(0.02), dtype(0.01)
    args_t = tuple(torch.tensor(v) for v in (A, b, lam, lr))
    args_j = tuple(jnp.asarray(v) for v in (A, b, lam, lr))
    ct = (torch.from_numpy(x), torch.from_numpy(x), torch.tensor(dtype(1.0)))
    cj = (jnp.asarray(x), jnp.asarray(x), jnp.asarray(dtype(1.0)))
    for _ in range(5):
        ct = fused.fista_step_dense_fused(*args_t, ct)
        cj = fista_step_dense_pallas(*args_j, cj, interpret=True)
    tol = dict(rtol=1e-12, atol=1e-13) if dtype == np.float64 else dict(rtol=2e-5, atol=2e-5)
    for g, r in zip(ct, cj):
        assert g.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def test_tails_are_their_plain_versions_on_the_cpu():
    rng = np.random.default_rng(8)
    y, g, x = (torch.from_numpy(rng.standard_normal(129)) for _ in range(3))
    t, lr, lam = (torch.tensor(v, dtype=torch.float64) for v in (2.5, 0.1, 0.4))
    for a, b in zip(fused.fista_tail(y, g, x, t, lr, lam),
                    fused.fista_tail_plain(y, g, x, t, lr, lam)):
        assert torch.equal(a, b)
    state = dict(
        err=torch.tensor(0.3, dtype=torch.float64), nit=torch.tensor(3, dtype=torch.int32),
        nit_internal=torch.tensor(3, dtype=torch.int32), converged=torch.tensor(False),
        failed=torch.tensor(False),
    )
    kw = dict(a=0, b=0.25, tol=1e-3, max_iter=10)
    got = fused.lasso_step_tail(y, g, x, t, lr, lam, **state, **kw)
    ref = fused.lasso_step_tail_plain(y, g, x, t, lr, lam, **state, **kw)
    assert isinstance(got, fused.StepTail) and got._fields == (
        "x", "y", "t", "err", "nit", "nit_internal", "converged"
    )
    for a, b in zip(got, ref):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert all(n == 0 for n in fused.launch_counts.values())
    # The tail composes the first entry's pass with the raw tail's scalars.
    xr, yr, tr = fused.fista_tail_plain(y, g, x, t, lr, lam)
    assert torch.equal(got.x, xr) and torch.equal(got.y, yr) and torch.equal(got.t, tr)
    assert int(got.nit) == 4 and int(got.nit_internal) == 4 and not bool(got.converged)


@pytest.mark.parametrize("entry", ["fused_prox_momentum", "fista_tail", "lasso_step_tail"])
def test_wrapper_rejects_devices_it_has_no_kernel_for(entry):
    # A tensor that is neither on the CPU nor on a CUDA device must not
    # silently take the plain version.
    v = torch.empty(4, device="meta")
    s = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if entry == "fused_prox_momentum":
            fused.fused_prox_momentum(v, v, v, 0.1, 0.05, 0.3)
        elif entry == "fista_tail":
            fused.fista_tail(v, v, v, s, s, s)
        else:
            fused.lasso_step_tail(
                v, v, v, s, s, s, s, s, s, s, s, a=0, b=0.25, tol=0.0, max_iter=1
            )


def test_build_raises_clearly_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_prox_momentum")
    assert "fused_prox_momentum" not in _build._LIBS
