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
    d0 = interop.dual_from_numpy(p0, q0, device="cpu")
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


@pytest.mark.parametrize("isotropic", [True, False])
def test_fgp_resident_plain_matches_pallas_interpret(isotropic):
    """The whole-image kernel's band plan against the TPU kernel in
    interpret mode (bands of 2, 4 and 24 rows: 12, 6 and 1 CTAs)."""
    assert [tv_cuda.resident_plan((24, 40), F64, s)[:2] for s in (12, 6, 1)] == [
        (2, 12), (4, 6), (24, 1)
    ]
    rng = np.random.default_rng(12)
    v = rng.standard_normal((24, 40))
    p0, q0 = _dual(rng, v.shape)
    ref = tv_pallas.fgp_pallas(
        jnp.asarray(0.15), jnp.asarray(v), jnp.asarray(p0), jnp.asarray(q0),
        n_iter=9, isotropic=isotropic, interpret=True,
    )
    for sms in (12, 6, 1):
        got = tv_cuda.fgp_resident_plain(
            0.15, torch.tensor(v), torch.tensor(p0), torch.tensor(q0), 9, isotropic, sms
        )
        for a, b in zip(got, ref):
            assert _rel(a.numpy(), b) <= RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "shape, sms", [((24, 40), 12), ((37, 53), 5), ((1, 31), 3), ((65, 7), 132), ((5, 9), 3)]
)
def test_fgp_resident_plain_is_bitwise_fgp_plain(shape, sms, dtype):
    """Bands of ceil(H / SMs) rows, halo rows refreshed every iteration:
    bitwise the whole-image loop, cold and warm, both discretizations;
    ragged last bands, one-row bands and a one-row image included."""
    rng = np.random.default_rng(sum(shape) + sms)
    v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    p0, q0 = (torch.tensor(d, dtype=dtype) for d in _dual(rng, shape))
    z = torch.zeros_like(v)
    for iso in (True, False):
        for dual in ((z, z), (p0, q0)):
            ref = tv_cuda.fgp_plain(0.2, v, *dual, 7, iso)
            got = tv_cuda.fgp_resident_plain(0.2, v, *dual, 7, iso, sms)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


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


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("shape", [(160, 128), (192, 128)])
def test_pipelined_window_plan_matches_pallas_pipelined_interpret(shape, isotropic):
    """The pipelined kernel's own window (80 x 30 in float64: three and
    two-and-a-half interiors of 64 rows, ten of 14 columns) against the
    TPU's pipelined strip kernel in interpret mode, warm dual, a full and a
    partial sweep."""
    rng = np.random.default_rng(14)
    v = rng.standard_normal(shape)
    p0, q0 = _dual(rng, shape)
    got = tv_cuda.fgp_tiles_plain(
        0.15, torch.tensor(v), torch.tensor(p0), torch.tensor(q0), 11, isotropic,
        pipelined=True,
    )
    ref = tv_pallas.fgp_pallas_strips(
        jnp.asarray(0.15), jnp.asarray(v), jnp.asarray(p0), jnp.asarray(q0),
        n_iter=11, isotropic=isotropic, interpret=True, pipelined=True,
    )
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) <= RTOL


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_iter", [8, 30])
@pytest.mark.parametrize("shape", [(100, 224), (160, 128)])
def test_fgp_tiles_plain_is_bitwise_fgp_plain(shape, n_iter, dtype, pipelined):
    """The CUDA tile kernels' plans — tiles with 8-cell halos, sweeps of 8
    then the remainder, t handed across sweeps, the serial or the
    pipelined kernel's window — are exact: bitwise the whole-image loop,
    cold and warm, both discretizations."""
    rng = np.random.default_rng(n_iter)
    v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    p0, q0 = (torch.tensor(d, dtype=dtype) for d in _dual(rng, shape))
    z = torch.zeros_like(v)
    for iso in (True, False):
        for dual in ((z, z), (p0, q0)):
            ref = tv_cuda.fgp_plain(0.2, v, *dual, n_iter, iso)
            got = tv_cuda.fgp_tiles_plain(0.2, v, *dual, n_iter, iso, pipelined)
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
        for pipelined in (False, True):
            got = tv_cuda.fgp_tiles_plain(0.3, v, z, z, 11, True, pipelined)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


def _straddling_shapes(dtype, pipelined):
    """Shapes at the edges of one tile's window and interior: one row, one
    column, and the interior's rows and columns less, equal and plus one."""
    ir, ic = tv_cuda.tile_interior(dtype, pipelined)
    wr, wc = tv_cuda.tile_window(dtype, pipelined)
    return [
        (1, ic + 1), (ir + 1, 1), (ir - 1, ic - 1), (ir, ic), (ir + 1, ic + 1),
        (2 * ir + 1, 2 * ic - 1), (wr + 1, wc - 1),
    ]


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fgp_tiles_plain_straddles_the_window(dtype, pipelined):
    """Bitwise the whole-image loop on shapes one cell either side of the
    window's and interior's edges, warm dual, a full and a partial sweep."""
    rng = np.random.default_rng(3)
    for shape in _straddling_shapes(dtype, pipelined):
        v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
        p0, q0 = (torch.tensor(d, dtype=dtype) for d in _dual(rng, shape))
        ref = tv_cuda.fgp_plain(0.25, v, p0, q0, 11, True)
        got = tv_cuda.fgp_tiles_plain(0.25, v, p0, q0, 11, True, pipelined)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), shape


def _skip_division(p, q):
    """The kernels' projection: the division by max(1, nrm) is skipped
    where nrm < 1 (csrc/fgp_tiles.cu, csrc/fgp_resident.cu project)."""
    nrm = torch.sqrt(p * p + q * q)
    keep = nrm < 1.0
    return torch.where(keep, p, p / nrm), torch.where(keep, q, q / nrm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_division_skip_is_bitwise_project(dtype):
    """p / max(1, nrm) == (p if nrm < 1 else p / nrm) bitwise: at and
    around the unit circle (nrm = 1 and 1 -+ 1 ulp), at +-0, +-inf, NaN and
    subnormals."""
    fi = torch.finfo(dtype)
    one = torch.tensor(1.0, dtype=dtype)
    below = torch.nextafter(one, torch.tensor(0.0, dtype=dtype))
    above = torch.nextafter(one, torch.tensor(2.0, dtype=dtype))
    sub = fi.tiny / 4
    special = [0.0, -0.0, 1.0, -1.0, float(below), float(above), -float(below),
               float("inf"), -float("inf"), float("nan"), sub, -sub, fi.tiny,
               fi.max, 0.6, 0.8, 3.0, -1e-300 if dtype == torch.float64 else -1e-40]
    vals = torch.tensor(special, dtype=dtype)
    p, q = torch.meshgrid(vals, vals, indexing="ij")
    # Points on the circle by rotation, nudged by an ulp either way.
    ang = torch.linspace(0, 6.3, 97, dtype=dtype)
    ring = [torch.cos(ang), torch.sin(ang)]
    p = torch.cat([p.reshape(-1), ring[0], torch.nextafter(ring[0], 2 * ring[0])])
    q = torch.cat([q.reshape(-1), ring[1], torch.nextafter(ring[1], 2 * ring[1])])
    want = tv_cuda._project(p, q, True)
    got = _skip_division(p, q)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int64 if dtype == torch.float64 else torch.int32),
                           b.view(torch.int64 if dtype == torch.float64 else torch.int32))


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
    # The whole-image kernel while one band of ceil(H / SMs) rows, with a
    # halo row above and below, fits a CTA's 227 KB (7 fields); the serial
    # tiles beyond.  An H100 has 132 SMs.
    f32 = torch.float32
    # (rows per CTA, CTAs, rows per warp, warps, bytes): bands per warp as
    # short as 32 warps allow, at most 16 rows.
    assert tv_cuda.resident_plan((256, 256), f32, 132) == (2, 128, 1, 18, 7 * 4 * 4 * 256)
    assert tv_cuda.resident_plan((24, 40), F64, 132) == (1, 24, 1, 2, 7 * 8 * 3 * 40)
    assert tv_cuda.resident_plan((1, 40), F64, 132) == (1, 1, 1, 2, 7 * 8 * 3 * 40)
    assert tv_cuda.resident_plan((2048, 64), f32, 132)[:4] == (16, 128, 2, 24)
    assert tv_cuda.resident_plan((5280, 1000), f32, 132)[:4] == (40, 132, 16, 32)
    assert tv_cuda.fits_resident((768, 768), f32, 132)
    assert not tv_cuda.fits_resident((1024, 1024), f32, 132)
    assert tv_cuda.fits_resident((512, 512), F64, 132)
    assert not tv_cuda.fits_resident((768, 768), F64, 132)
    assert tv_cuda.fits_resident((600, 520), F64, 132)
    for shape in ((24, 40), (256, 256), (768, 768)):
        assert tv_cuda.choose(shape, f32, 132) == "cuda_resident"
    assert tv_cuda.choose((256, 256), F64, 132) == "cuda_resident"
    for shape in ((1024, 1024), (2048, 2048), (3, 10**6)):
        assert tv_cuda.choose(shape, f32, 132) == "cuda_tiles"
    # Fewer SMs, taller bands: the shared-memory bound comes sooner.
    assert tv_cuda.choose((768, 768), f32, 72) == "cuda_tiles"
    # The serial tiles: 64 x 120 windows (48 x 104 interiors) in float32,
    # 64 x 60 in float64; the pipelined tiles 80 x 60 and 80 x 30.
    assert tv_cuda.n_tiles((256, 256), f32) == 6 * 3
    assert tv_cuda.n_tiles((2048, 2048), f32) == 43 * 20
    assert tv_cuda.n_tiles((768, 768), f32, pipelined=True) == 12 * 18
    assert tv_cuda.n_tiles((100, 224), F64) == 3 * 6
    assert tv_cuda.tile_interior(f32) == (48, 104)
    assert tv_cuda.tile_interior(F64) == (48, 44)
    assert tv_cuda.tile_interior(f32, pipelined=True) == (64, 44)
    assert tv_cuda.tile_interior(F64, pipelined=True) == (64, 14)
    assert tv_cuda.resolve((2048, 2048), f32, "cpu") == "plain"
    assert tv_cuda.resolve((2048, 2048), f32, torch.device("cpu")) == "plain"
    assert set(tv_cuda.KERNEL_NAMES) >= {"cuda_resident", "cuda_tiles", "plain"}
    # A card whose CTAs may use less shared memory takes the tiles sooner.
    assert tv_cuda.choose((512, 512), f32, 132) == "cuda_resident"
    assert tv_cuda.choose((512, 512), f32, 132, smem_optin=80_000) == "cuda_tiles"
    # The pipelined tiles are pinned by a method of their own; on a CPU
    # tensor it is the plain loop, bitwise.
    assert tv.PIPELINED in tv_cuda.KERNEL_NAMES
    w = torch.tensor(np.random.default_rng(9).standard_normal((9, 11)))
    ref = tv.prox_tv(0.1, w, n_iter=6, method="xla")
    assert torch.equal(tv.prox_tv(0.1, w, n_iter=6, method=tv.PIPELINED), ref)
    assert torch.equal(tv_cuda.fgp(0.1, w, w * 0, w * 0, 6, pipelined=True)[0], ref)
    for method in ("cuda_resident", "cuda_tiles"):
        with pytest.raises(ValueError, match="method"):
            tv.prox_tv(0.1, w, method=method)


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


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_windows_fit_a_ctas_shared_memory(dtype, pipelined):
    """Fields x window cells x itemsize within the bytes one CTA may opt in
    to; whole warp columns; rows of whole 16-byte groups (the vector
    copies); the same bytes in either dtype."""
    wh, ww = tv_cuda.tile_window(dtype, pipelined)
    item = torch.empty((), dtype=dtype).element_size()
    fields = tv_cuda.PIPELINED_FIELDS if pipelined else tv_cuda.TILE_FIELDS
    assert fields * wh * ww * item <= tv_cuda.SMEM_OPTIN_BYTES
    assert ww % tv_cuda.WALK_LANES == 0
    assert (ww * item) % 16 == 0 and ((ww - 2 * tv_cuda.HALO) * item) % 16 == 0
    assert wh > 2 * tv_cuda.HALO and ww > 2 * tv_cuda.HALO
    other = torch.float64 if dtype == torch.float32 else torch.float32
    oh, ow = tv_cuda.tile_window(other, pipelined)
    assert wh * ww * item == oh * ow * torch.empty((), dtype=other).element_size()


def test_pipelined_window_spends_the_budget_and_quantizes_768():
    """The pipelined window leaves under one more row of its 12 fields
    unused, and cuts the 768 x 768 main-path image into two rounds of an
    H100's 132 persistent CTAs (the 64 x 60 window it replaces made three)."""
    wh, ww = tv_cuda.tile_window(torch.float32, pipelined=True)
    used = tv_cuda.PIPELINED_FIELDS * wh * ww * 4
    assert used == 230_400
    assert used + tv_cuda.PIPELINED_FIELDS * ww * 4 > tv_cuda.SMEM_OPTIN_BYTES
    tiles = tv_cuda.n_tiles((768, 768), torch.float32, pipelined=True)
    assert tiles == 216 and -(-tiles // 132) == 2
    assert -(-(16 * 18) // 132) == 3
    assert tv_cuda.n_tiles((2048, 2048), torch.float32, pipelined=True) == 32 * 47
