"""The port's TV prox vs the JAX package's, float64 on the CPU.

The port runs its plain versions here (a CPU tensor never reaches a CUDA
kernel); the JAX side runs its XLA loop, and its Pallas kernels in
interpret mode, as tests/test_tv.py does.  The tile plan of the CUDA tile
kernels is checked through ``fgp_tiles_plain``, which must equal the
whole-image loop bitwise.  The CUDA kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.ops import tv as jtv
from zfista_tpu.ops import tv_pallas
from zfista_tpu_torch import interop
from zfista_tpu_torch.ops import tv, tv_cuda

F64 = torch.float64
# JAX x64 vs torch float64: the same formulas, but XLA may contract
# multiply-adds and the CPU's float64 sqrt differs from IEEE by an ulp
# (tv_cuda._sweeps), so agreement is to a few ulps compounded over the
# dual iterations, not bitwise.
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _dual(rng, shape):
    """A feasible warm-start dual: |(p, q)| <= 1, structural zeros kept."""
    p = np.clip(rng.standard_normal(shape) * 0.5, -0.7, 0.7)
    q = np.clip(rng.standard_normal(shape) * 0.5, -0.7, 0.7)
    p[-1, :] = 0
    q[:, -1] = 0
    return p, q


def test_grad_div_adjoint_and_match_jax():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((7, 5))
    p, q = _dual(rng, (7, 5))
    gx, gy = tv._grad2d(torch.tensor(u))
    lhs = float(torch.sum(gx * torch.tensor(p)) + torch.sum(gy * torch.tensor(q)))
    rhs = -float(torch.sum(torch.tensor(u) * tv._div2d(torch.tensor(p), torch.tensor(q))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    jgx, jgy = jtv._grad2d(jnp.asarray(u))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    np.testing.assert_array_equal(
        tv._div2d(torch.tensor(p), torch.tensor(q)).numpy(),
        np.asarray(jtv._div2d(jnp.asarray(p), jnp.asarray(q))),
    )


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (7, 5), (32, 32)])
def test_tv2d_matches_jax(shape, isotropic):
    u = np.random.default_rng(1).standard_normal(shape)
    got = float(tv.tv2d(torch.tensor(u), isotropic))
    ref = float(jtv.tv2d(jnp.asarray(u), isotropic))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("shape", [(7, 5), (24, 40), (32, 32)])
def test_prox_tv_matches_jax(shape, isotropic):
    """Cold and warm starts, the returned dual, and lam <= 0, against the
    JAX ``prox_tv(method="xla")``."""
    rng = np.random.default_rng(sum(shape))
    v = rng.standard_normal(shape)
    lam = 0.15
    vt, vj = torch.tensor(v), jnp.asarray(v)
    kw = dict(n_iter=30, isotropic=isotropic)
    u_t, (p_t, q_t) = tv.prox_tv(lam, vt, return_dual=True, **kw)
    u_j, (p_j, q_j) = jtv.prox_tv(lam, vj, return_dual=True, method="xla", **kw)
    for got, ref in ((u_t, u_j), (p_t, p_j), (q_t, q_j)):
        assert _rel(got.numpy(), ref) <= RTOL
    # Warm start from a dual carried across with interop.
    p0, q0 = _dual(rng, shape)
    d0 = interop.dual_from_numpy(p0, q0)
    assert d0[0].dtype == F64 and np.array_equal(d0[0].numpy(), p0)
    u_t = tv.prox_tv(lam, vt, dual0=d0, **kw)
    u_j = jtv.prox_tv(lam, vj, dual0=(jnp.asarray(p0), jnp.asarray(q0)), method="xla", **kw)
    assert _rel(u_t.numpy(), u_j) <= RTOL
    # lam <= 0 returns v exactly, on both sides.
    for z in (0.0, -0.5):
        np.testing.assert_array_equal(tv.prox_tv(z, vt, **kw).numpy(), v)
        np.testing.assert_array_equal(
            np.asarray(jtv.prox_tv(z, vj, method="xla", **kw)), v
        )
    # "auto" and "pallas" take the plain loop on a CPU tensor: bitwise "xla".
    u_x = tv.prox_tv(lam, vt, method="xla", **kw)
    for method in ("auto", "pallas"):
        assert torch.equal(tv.prox_tv(lam, vt, method=method, **kw), u_x)


@pytest.mark.parametrize("isotropic", [True, False])
def test_tv_dual_gap_matches_jax(isotropic):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((24, 40))
    u_t, d_t = tv.prox_tv(0.15, torch.tensor(v), n_iter=40, isotropic=isotropic, return_dual=True)
    g_t = float(tv.tv_dual_gap(0.15, torch.tensor(v), u_t, d_t, isotropic))
    g_j = float(
        jtv.tv_dual_gap(
            0.15, jnp.asarray(v), jnp.asarray(u_t.numpy()),
            tuple(jnp.asarray(d.numpy()) for d in d_t), isotropic,
        )
    )
    assert g_t >= 0
    # The gap is a difference of sums of order 10 that the two packages
    # reduce in different orders: equal to ~1e-12 of that scale.
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-11)


@pytest.mark.parametrize("isotropic", [True, False])
def test_fgp_plain_matches_pallas_interpret(isotropic):
    rng = np.random.default_rng(11)
    v = rng.standard_normal((24, 40))
    p0, q0 = _dual(rng, v.shape)
    for n_iter in (8, 25):
        got = tv_cuda.fgp_plain(
            0.15, torch.tensor(v), torch.tensor(p0), torch.tensor(q0), n_iter, isotropic
        )
        ref = tv_pallas.fgp_pallas(
            jnp.asarray(0.15), jnp.asarray(v), jnp.asarray(p0), jnp.asarray(q0),
            n_iter=n_iter, isotropic=isotropic, interpret=True,
        )
        for a, b in zip(got, ref):
            assert _rel(a.numpy(), b) <= RTOL


@pytest.mark.parametrize("pipelined", [False, True])
def test_fgp_tiles_plain_matches_pallas_strips_interpret(pipelined):
    """tests/test_tv.py's strip shape: (160, 128), n_iter=8."""
    rng = np.random.default_rng(13)
    v = rng.standard_normal((160, 128))
    z = np.zeros_like(v)
    got = tv_cuda.fgp_tiles_plain(
        0.15, torch.tensor(v), torch.tensor(z), torch.tensor(z), 8, True
    )
    ref = tv_pallas.fgp_pallas_strips(
        jnp.asarray(0.15), jnp.asarray(v), jnp.asarray(z), jnp.asarray(z),
        n_iter=8, isotropic=True, interpret=True, pipelined=pipelined,
    )
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) <= RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_iter", [8, 30])
@pytest.mark.parametrize("shape", [(100, 224), (160, 128)])
def test_fgp_tiles_plain_is_bitwise_fgp_plain(shape, n_iter, dtype):
    """The CUDA tile kernels' plan — tiles with 8-cell halos, sweeps of 8
    then the remainder, t handed across sweeps — is exact: bitwise the
    whole-image loop, cold and warm, both discretizations."""
    rng = np.random.default_rng(n_iter)
    v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    p0, q0 = (torch.tensor(d, dtype=dtype) for d in _dual(rng, shape))
    z = torch.zeros_like(v)
    for iso in (True, False):
        for dual in ((z, z), (p0, q0)):
            ref = tv_cuda.fgp_plain(0.2, v, *dual, n_iter, iso)
            got = tv_cuda.fgp_tiles_plain(0.2, v, *dual, n_iter, iso)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fgp_tiles_plain_ragged_shapes(dtype):
    """Images smaller than one window, one-pixel images, ragged last tiles
    in both directions."""
    rng = np.random.default_rng(2)
    for shape in ((1, 1), (3, 70), (37, 53), (49, 97)):
        v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
        z = torch.zeros_like(v)
        ref = tv_cuda.fgp_plain(0.3, v, z, z, 11, True)
        got = tv_cuda.fgp_tiles_plain(0.3, v, z, z, 11, True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_cpu_wrappers_take_plain_versions_and_never_count():
    for name in tv_cuda.launch_counts:
        tv_cuda.launch_counts[name] = 0
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.standard_normal((40, 56)))
    z = torch.zeros_like(v)
    ref = tv_cuda.fgp_plain(0.1, v, z, z, 12, True)
    for got in (
        tv_cuda.fgp_resident(0.1, v, z, z, 12, True),
        tv_cuda.fgp_tiles(0.1, v, z, z, 12, True, pipelined=False),
        tv_cuda.fgp_tiles(0.1, v, z, z, 12, True, pipelined=True),
        tv_cuda.fgp(0.1, v, z, z, 12, True),
    ):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    tv.prox_tv(0.1, v, n_iter=5)
    assert all(n == 0 for n in tv_cuda.launch_counts.values())


def test_methods_and_dispatch_rules():
    v = torch.zeros((8, 8), dtype=F64)
    with pytest.raises(ValueError, match="interpreter"):
        tv.prox_tv(0.1, v, method="pallas_interpret")
    with pytest.raises(ValueError, match="method"):
        tv.prox_tv(0.1, v, method="nope")
    # The whole-image kernel while 12 fields fit half the L2; tiles past it.
    assert tv_cuda.fits_l2((512, 512), torch.float32)
    assert not tv_cuda.fits_l2((1024, 1024), torch.float32)
    assert tv_cuda.fits_l2((512, 512), torch.float64)
    assert not tv_cuda.fits_l2((600, 600), torch.float64)
    # The whole-image kernel while it fits and the tiles would leave over
    # half the SMs idle; then pipelined tiles while the serial kernel's
    # tiles fit one wave (2 CTAs per SM); serial tiles beyond.  An H100 has
    # 132 SMs.
    f32 = torch.float32
    assert tv_cuda.n_tiles((256, 256), f32) == 36
    assert tv_cuda.choose((256, 256), f32, 132) == "cuda_resident"
    assert tv_cuda.choose((256, 256), f32, 72) == "cuda_tiles_pipelined"
    assert tv_cuda.choose((512, 512), f32, 132) == "cuda_tiles_pipelined"
    assert tv_cuda.choose((24, 40), torch.float64, 132) == "cuda_resident"
    assert tv_cuda.n_tiles((768, 768), f32) == 256
    assert tv_cuda.choose((768, 768), f32, 132) == "cuda_tiles_pipelined"
    assert tv_cuda.choose((768, 768), f32, 100) == "cuda_tiles"
    for shape in ((1024, 1024), (2048, 2048), (3, 10**6)):
        assert tv_cuda.choose(shape, f32, 132) == "cuda_tiles"
    # On a card with many more SMs the L2 guard, not the SM rule, binds.
    assert tv_cuda.choose((512, 512), f32, 1000) == "cuda_resident"
    assert tv_cuda.choose((1024, 1024), f32, 10_000) == "cuda_tiles_pipelined"
    assert tv_cuda.n_tiles((100, 224), torch.float64) == 3 * 14
    assert tv_cuda.resolve((2048, 2048), f32, "cpu") == "plain"
    assert tv_cuda.resolve((2048, 2048), f32, torch.device("cpu")) == "plain"
    assert set(tv_cuda.KERNEL_NAMES) >= {"cuda_resident", "cuda_tiles", "plain"}
    assert tv_cuda.tile_interior(torch.float32) == (48, 48)
    assert tv_cuda.tile_interior(torch.float64) == (48, 16)


def test_sweep_plan_replays_t_like_the_plain_loop():
    """Sweeps of 8 then the remainder; each start t is the plain loop's t
    after that many iterations, in the field's dtype, exactly."""
    for dtype in (torch.float32, torch.float64):
        plan = tv_cuda._sweeps(30, dtype, torch.device("cpu"))
        assert [k for _, k in plan] == [8, 8, 8, 6]
        t = torch.ones((), dtype=dtype)
        for i in range(30):
            if i % 8 == 0:
                assert plan[i // 8][0] == float(t)
            t = tv_cuda._t_next(t)
    assert tv_cuda._sweeps(0, torch.float32, torch.device("cpu")) == ()
    assert [k for _, k in tv_cuda._sweeps(5, F64, torch.device("cpu"))] == [5]
