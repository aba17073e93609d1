"""The port's TV-deblurring model vs the JAX package's, float64 on the CPU.

The blur operators, the model's pieces, ``TVDeblur.solve`` through the
fixed-step solver's generic prox branch, and the warm-dual
``solve_warm`` loop.  The prox runs its plain loop here (a CPU image);
chip_smoke.py runs the same path on the card through the CUDA kernels.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import warnings
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models import deblur as jd
from zfista_tpu_torch import interop
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import TVDeblur
from zfista_tpu_torch.models import deblur as td
from zfista_tpu_torch.ops import tv, tv_cuda

F64 = torch.float64


def _scene(size=32, seed=0, noise=0.01):
    """tests/test_tv.py's blurred scene: two flat blocks, Gaussian 9x9
    sigma=2, numpy noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size))
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
    img[size // 2 :, : size // 2] = 0.5
    kernel = jd.gaussian_kernel(9, 2.0)
    observed = np.array(jd.make_blur(kernel)(jnp.asarray(img)))
    observed += noise * rng.standard_normal(observed.shape)
    return img, observed, kernel


def _kernels():
    rng = np.random.default_rng(0)
    motion = rng.random((5, 5))
    return {
        "gauss9_separable": jd.gaussian_kernel(9, 2.0),
        "gauss4_even_conv": jd.gaussian_kernel(4, 1.0),
        "random5_odd_conv": motion / motion.sum(),
        "random4x6_even_conv": rng.random((4, 6)),
    }


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("name", sorted(_kernels()))
def test_make_blur_matches_jax(name, adjoint):
    k = _kernels()[name]
    img = np.random.default_rng(1).standard_normal((20, 24))
    got = td.make_blur(k, adjoint=adjoint)(torch.tensor(img)).numpy()
    ref = np.asarray(jd.make_blur(k, adjoint=adjoint)(jnp.asarray(img)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    assert (td._separable_taps(k) is None) == (jd._separable_taps(k) is None)


@pytest.mark.parametrize("name", sorted(_kernels()))
def test_make_blur_adjoint_identity(name):
    """<blur x, y> == <x, blur* y>: the even kernels need the swapped pad."""
    k = _kernels()[name]
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((17, 23)))
    y = torch.tensor(rng.standard_normal((17, 23)))
    lhs = float(torch.sum(td.make_blur(k)(x) * y))
    rhs = float(torch.sum(x * td.make_blur(k, adjoint=True)(y)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_host_helpers_match_jax():
    for size, sigma in ((9, 4.0), (5, 1.5), (4, 1.0)):
        np.testing.assert_array_equal(
            td.gaussian_kernel(size, sigma), jd.gaussian_kernel(size, sigma)
        )
    k = jd.gaussian_kernel()
    for shape in ((16, 16), (32, 48)):
        assert td.blur_lipschitz(k, shape) == jd.blur_lipschitz(k, shape)
    taps = td._separable_taps(k)
    np.testing.assert_array_equal(td._band_matrix(taps, 12), jd._band_matrix(taps, 12))
    for size in (16, 37):
        got = td.synthetic_cameraman(size, dtype=F64, device="cpu").numpy()
        ref = np.asarray(jd.synthetic_cameraman(size))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    assert td.synthetic_cameraman(8, device="cpu").dtype == torch.get_default_dtype()


@pytest.mark.parametrize("isotropic", [True, False])
def test_model_pieces_match_jax(isotropic):
    _, observed, kernel = _scene(size=24)
    kw = dict(tv_ratio=1e-3, kernel=kernel, prox_iter=20, isotropic=isotropic)
    pt = TVDeblur(observed, device="cpu", **kw)
    pj = jd.TVDeblur(observed, **kw)
    x = np.random.default_rng(3).standard_normal(24 * 24)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for name in ("f", "jac_f", "g"):
        got = getattr(pt, name)(xt).numpy()
        ref = np.asarray(getattr(pj, name)(xj))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, err_msg=name)
    got = pt.prox_wsum_g(0.7, xt).numpy()
    ref = np.asarray(pj.prox_wsum_g(0.7, xj))
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert pt.lipschitz() == pj.lipschitz()
    np.testing.assert_array_equal(pt.x0().numpy(), np.asarray(pj.x0()))


@pytest.mark.parametrize(
    "seed, tol, max_iter",
    [(0, 1e-8, 120), (1, 1e-8, 120), (0, 1e-4, 3000), (1, 1e-4, 3000)],
)
def test_solve_matches_jax(seed, tol, max_iter):
    """The slice end to end on the solver's generic prox branch: same
    explicit lr, prox_method="xla" on both sides.  At tol 1e-8 the inexact
    prox (30 dual iterations) floors the criterion above tol, so both run
    to max_iter; at tol 1e-4 the solve converges and the data set nit."""
    _, observed, kernel = _scene(seed=seed)
    lr = 1.0 / jd.blur_lipschitz(kernel, observed.shape)
    kw = dict(tv_ratio=1e-3, kernel=kernel, prox_iter=30, prox_method="xla")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rj = jd.TVDeblur(observed, **kw).solve(lr=lr, tol=tol, max_iter=max_iter)
        rt = TVDeblur(observed, device="cpu", **kw).solve(lr=lr, tol=tol, max_iter=max_iter)
    assert rt.status == rj.status == (1 if tol == 1e-4 else 0)
    assert rt.nit == rj.nit
    assert rt.nit_internal == rj.nit_internal
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-12)
    assert rt.lr == lr


@pytest.mark.parametrize("seed, tol", [(0, 1e-4), (1, 1e-3)])
def test_solve_warm_matches_jax(seed, tol):
    _, observed, kernel = _scene(seed=seed)
    kw = dict(tv_ratio=1e-3, kernel=kernel)
    wj = jd.TVDeblur(observed, **kw).solve_warm(max_iter=1000, tol=tol, prox_iter=8)
    wt = TVDeblur(observed, device="cpu", **kw).solve_warm(max_iter=1000, tol=tol, prox_iter=8)
    assert wt["nit"] == wj["nit"] < 1000
    np.testing.assert_allclose(wt["x"], wj["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(wt["fun"], wj["fun"], rtol=1e-12)
    assert wt["error_criterion"] < tol
    assert isinstance(wt["x"], np.ndarray) and wt["x"].shape == (32 * 32,)


def test_solve_warm_requires_separable_kernel():
    rng = np.random.default_rng(0)
    k = rng.random((5, 5))
    _, observed, _ = _scene(size=16)
    with pytest.raises(ValueError, match="separable"):
        TVDeblur(observed, device="cpu", kernel=k / k.sum()).solve_warm()


@pytest.mark.parametrize("stop", ["converged", "max_iter"])
def test_check_every_is_bitwise(stop):
    """check_every 1 and 64 give the same State (solve) and the same carry
    (solve_warm's driver), nit included."""
    _, observed, kernel = _scene(size=16, seed=2)
    prob = TVDeblur(observed, device="cpu", tv_ratio=1e-3, kernel=kernel, prox_iter=10)
    kw = dict(tol=1e-3) if stop == "converged" else dict(tol=0, max_iter=70)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        runs = {ce: prob.solve(check_every=ce, **kw) for ce in (1, 64)}
    assert runs[1].status == (1 if stop == "converged" else 0)
    assert runs[1].nit == runs[64].nit
    for name, a, c in zip(solver.State._fields, runs[1].state, runs[64].state):
        assert np.array_equal(a, c), name

    Gr, Gc = prob._bands()
    b = prob.b
    args = (
        b, Gr, Gc, torch.tensor(1e-3, dtype=F64),
        torch.tensor(1.0 / prob.lipschitz(), dtype=F64),
        torch.tensor(kw["tol"], dtype=F64), kw.get("max_iter", 1000), 8, True,
    )
    ref = td._tv_warm_driver(*args, check_every=1)
    got = td._tv_warm_driver(*args, check_every=64)
    for a, c in zip(ref[:4] + ref[4], got[:4] + got[4]):
        assert torch.equal(a, c)


def test_masked_chunk_keeps_a_frozen_steps_nan_out():
    """A masked step that runs after the stop computes whatever it likes —
    here NaN — and the carry keeps its frozen value."""

    class Carry(NamedTuple):
        x: torch.Tensor
        k: torch.Tensor

    def nan_step(c):
        return Carry(torch.full_like(c.x, float("nan")), c.k + 1)

    def active(c):
        return c.k < 3

    x0 = torch.ones(4, dtype=F64)
    k0 = torch.zeros((), dtype=torch.int32)
    c = solver.run_masked(lambda c: Carry(c.x + 1, c.k + 1), Carry(x0, k0), active, 64)
    assert int(c.k) == 3 and torch.equal(c.x, x0 + 3)
    c = solver.run_masked(nan_step, Carry(x0, k0), active, 64)
    assert int(c.k) == 3 and torch.isnan(c.x).all()  # active steps' NaN shows
    done = Carry(x0, torch.tensor(3, dtype=torch.int32))
    c = solver.run_masked(nan_step, done, active, 64)
    assert torch.equal(c.x, x0)  # no active step: nothing runs
    # Stopped mid-chunk: the 61 frozen steps' NaN never reaches the carry.
    c = solver.run_masked(
        lambda c: Carry(torch.where(c.k < 3, c.x + 1, float("nan")), c.k + 1),
        Carry(x0, k0), active, 64,
    )
    assert int(c.k) == 3 and torch.equal(c.x, x0 + 3)


def test_checkpoint_meta_on_cpu():
    _, observed, kernel = _scene(size=16)
    for method in ("auto", "pallas", "xla"):
        meta = TVDeblur(observed, device="cpu", kernel=kernel, prox_method=method).checkpoint_meta()
        assert meta["prox_kernel"] == "plain"
        assert meta["backend"] == "cpu"
        assert meta["prox_method"] == method
        assert meta["problem"] == "TVDeblur"
    with pytest.raises(ValueError, match="interpreter"):
        TVDeblur(observed, device="cpu", prox_method="pallas_interpret")


@pytest.mark.parametrize("separable", [True, False])
def test_tv_deblur_params_from_numpy_round_trip(separable):
    """The JAX params tuple, fetched to numpy, drives the port's
    params-style callables to the JAX callables' values."""
    _, observed, kernel = _scene(size=16, seed=4)
    if not separable:
        kernel = _kernels()["random5_odd_conv"]
    pj = jd.TVDeblur(observed, tv_ratio=1e-3, kernel=kernel, prox_iter=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pj.solve(max_iter=2, tol=0)
    params_np = [np.asarray(a) for a in pj._params]
    p = interop.tv_deblur_params_from_numpy(*params_np, device="cpu")
    assert len(p) == (4 if separable else 3)
    for a, ref in zip(p, params_np):
        assert a.dtype == F64 and np.array_equal(a.numpy(), ref)
    fns_t = td._tv_deblur_callables(12, True, separable)
    fns_j = jd._tv_deblur_callables(12, True, separable)
    x = np.random.default_rng(5).standard_normal(16 * 16)
    for ft, fj in zip(fns_t[:3], fns_j[:3]):
        np.testing.assert_allclose(
            ft(torch.tensor(x), p).numpy(), np.asarray(fj(jnp.asarray(x), pj._params)),
            rtol=1e-12, atol=1e-12,
        )
    got = fns_t[3](torch.tensor([0.5], dtype=F64), torch.tensor(x), p).numpy()
    ref = np.asarray(fns_j[3](jnp.asarray([0.5]), jnp.asarray(x), pj._params))
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    with pytest.raises(ValueError, match="expected"):
        interop.tv_deblur_params_from_numpy(observed, kernel, device="cpu")


def test_deblur_on_cpu_never_launches():
    for name in tv_cuda.launch_counts:
        tv_cuda.launch_counts[name] = 0
    _, observed, kernel = _scene(size=16)
    prob = TVDeblur(torch.tensor(observed, dtype=torch.float32), kernel=kernel, prox_iter=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = prob.solve(max_iter=5, tol=0)
    assert res.nit == 5 and res.x.dtype == np.float32
    assert all(n == 0 for n in tv_cuda.launch_counts.values())
    assert tv.prox_tv(0.1, prob.b).dtype == torch.float32
