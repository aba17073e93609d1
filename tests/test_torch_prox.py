"""The port's prox library vs zfista_tpu.ops.prox, float64 on the CPU.

Same inputs (numpy seeds) through both; values bitwise or at 1e-15, and
the generalized derivatives at ties, which the m>=3 Newton dual's Hessian
is built from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.ops import prox as jp
from zfista_tpu_torch.ops import prox as tp

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def test_soft_threshold_shifted_and_box_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(257)
    x[:4] = [0.3, -0.3, 0.0, 1e-300]  # ties with thresh 0.3, zeros
    for thresh in (0.3, 0.0, 2.5):
        np.testing.assert_array_equal(
            tp.soft_threshold(_t(x), thresh).numpy(),
            np.asarray(jp.soft_threshold(jnp.asarray(x), thresh)),
        )
    shift = rng.standard_normal(257)
    np.testing.assert_array_equal(
        tp.prox_shifted_l1(_t(x), 0.2, _t(shift)).numpy(),
        np.asarray(jp.prox_shifted_l1(jnp.asarray(x), 0.2, jnp.asarray(shift))),
    )
    for lo, hi in ((-0.5, 0.5), (0.0, np.inf), (-np.inf, 0.1)):
        np.testing.assert_array_equal(
            tp.project_box(_t(x), lo, hi).numpy(),
            np.asarray(jp.project_box(jnp.asarray(x), lo, hi)),
        )


@pytest.mark.parametrize(
    "v",
    [
        [0.2, 0.3, 0.5],  # already on the simplex
        [1.0, 1.0, 1.0, 1.0],  # all tied
        [0.7, 0.7, -2.0, 0.1],  # a tied pair at the top
        [-1.0, -1.0, -1.0],  # tied and below
        [5.0, -3.0, 0.0, 0.0, 2.0],
    ],
)
def test_project_simplex_ties(v):
    got = tp.project_simplex(_t(v)).numpy()
    ref = np.asarray(jp.project_simplex(jnp.asarray(v, jnp.float64)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    assert np.all(got >= 0) and abs(got.sum() - 1) < 1e-12


def test_project_simplex_batch_dimension():
    v = np.random.default_rng(1).standard_normal((4, 3, 5)) * 3
    got = tp.project_simplex(_t(v)).numpy()
    ref = np.asarray(jp.project_simplex(jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    rows = np.stack([tp.project_simplex(_t(r)).numpy() for r in v.reshape(-1, 5)])
    np.testing.assert_array_equal(got.reshape(-1, 5), rows)


@pytest.mark.parametrize(
    "ratios, shifts, bounds",
    [
        ([0.2, 0.4], [0.0, -1.0], None),  # JOS1 + L1 in the harness
        ([0.1, 0.1, 0.1], [0.0, 1.0, -1.0], None),  # FDS + L1
        ([0.5, 0.3, 0.2, 0.1], None, None),  # None shifts mean zeros
        ([0.25, 0.25], [0.0, 0.0], (-0.5, 0.7)),
        (None, None, (1e-6, np.inf)),  # box only (SD, ZDT1)
        ([0.3, 0.1], [0.5, -0.5], (0.0, np.inf)),  # nonzero first shift
    ],
)
def test_wsum_prox_matches_jax(ratios, shifts, bounds):
    rng = np.random.default_rng(2)
    m = 2 if ratios is None else len(ratios)
    lo, hi = (None, None) if bounds is None else bounds
    jprox = jp.make_wsum_shifted_l1_box_prox(
        None if ratios is None else np.asarray(ratios),
        None if shifts is None else np.asarray(shifts),
        lo,
        hi,
    )
    tprox = tp.make_wsum_shifted_l1_box_prox(ratios, shifts, lo, hi)
    for _ in range(5):
        x = rng.standard_normal(40) * 2
        w = rng.uniform(0, 1, m) * 0.7
        np.testing.assert_allclose(
            tprox(_t(w), _t(x)).numpy(),
            np.asarray(jprox(jnp.asarray(w), jnp.asarray(x))),
            rtol=0,
            atol=1e-15,
        )
    # The zero weight (project_momentum's call) is the box projection.
    x = rng.standard_normal(40)
    np.testing.assert_array_equal(
        tprox(torch.zeros(m, dtype=F64), _t(x)).numpy(),
        np.asarray(jprox(jnp.zeros(m), jnp.asarray(x))),
    )


def test_wsum_prox_scalar_weight_single_objective():
    x = np.random.default_rng(3).standard_normal(9)
    jprox = jp.make_wsum_shifted_l1_box_prox(np.array([0.5]), None, None, None)
    tprox = tp.make_wsum_shifted_l1_box_prox([0.5], None, None, None)
    np.testing.assert_array_equal(
        tprox(0.4, _t(x)).numpy(), np.asarray(jprox(0.4, jnp.asarray(x)))
    )
    np.testing.assert_array_equal(
        tprox(torch.tensor(0.4, dtype=F64), _t(x)).numpy(),
        np.asarray(jprox(jnp.asarray(0.4), jnp.asarray(x))),
    )


def test_first_shift_quirk_matches_reference():
    """tests/test_problems.py's pin of the reference quirk, for the port:
    the first objective's shift is ignored by the prox."""
    prox = tp.make_wsum_shifted_l1_box_prox([0.5], [2.0], None, None)
    x = _t([0.3, -1.4, 2.2])
    w = _t([0.4])
    got = prox(w, x)
    coef = w * 0.5
    ref = tp.soft_threshold(x + 0.0 - 2.0 + 2.0, coef[0])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-15)
    shifted = tp.soft_threshold(x - 2.0, coef[0]) + 2.0
    assert not np.allclose(got.numpy(), shifted.numpy())
    jgot = jp.make_wsum_shifted_l1_box_prox(np.array([0.5]), np.array([2.0]), None, None)(
        jnp.asarray([0.4]), jnp.asarray([0.3, -1.4, 2.2])
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_prox_group_lasso_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 24))
    x[0, :4] = 0.0  # a zero group: the 1e-30 floor
    for scale in (0.5, 3.0):
        np.testing.assert_allclose(
            tp.prox_group_lasso(_t(x), scale, 4).numpy(),
            np.asarray(jp.prox_group_lasso(jnp.asarray(x), scale, 4)),
            rtol=0,
            atol=1e-15,
        )
    with pytest.raises(ValueError, match="group_size"):
        tp.prox_group_lasso(_t(x), 0.5, 5)


def test_generalized_derivatives_at_ties_match_jax():
    """At |x| == thresh (soft-threshold) and x == bound (box) the JAX
    ``maximum``/``minimum`` derivative splits 1/2-1/2.  The port's prox
    gives the same Jacobian in forward and in reverse mode (the Newton
    dual's Hessian is taken in reverse mode)."""
    ratios, shifts, lo, hi = [0.5, 0.25], [0.0, 0.5], -0.75, 1.0
    jprox = jp.make_wsum_shifted_l1_box_prox(np.array(ratios), np.array(shifts), lo, hi)
    tprox = tp.make_wsum_shifted_l1_box_prox(ratios, shifts, lo, hi)
    w = np.array([0.5, 0.4])
    # x + sum(coef[1:]) = +-coef[0] (a first-term tie), a second-term tie,
    # and a point landing exactly on each bound.
    c0, c1 = 0.25, 0.1
    x = np.array([c0 - c1, -c0 - c1, 0.5 + 2 * c1 + 0.3, 0.2, -3.0, 5.0])
    for argnum in (0, 1):
        jj = np.asarray(
            jax.jacfwd(lambda *a: jprox(*a), argnums=argnum)(jnp.asarray(w), jnp.asarray(x))
        )
        for jac in (torch.func.jacfwd, torch.func.jacrev):
            tj = jac(lambda *a: tprox(*a), argnums=argnum)(_t(w), _t(x)).numpy()
            np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-15, err_msg=str(jac))
    assert np.any(np.asarray(jax.jacfwd(jprox, argnums=1)(jnp.asarray(w), jnp.asarray(x))) == 0.5)

    t = np.array([0.3, -0.3, 0.1, 1.0])
    jj = np.asarray(jax.jacfwd(jp.soft_threshold, argnums=(0, 1))(jnp.asarray(t), 0.3)[0])
    tj = torch.func.jacrev(tp.soft_threshold)(_t(t), torch.tensor(0.3, dtype=F64)).numpy()
    np.testing.assert_array_equal(tj, jj)
    assert tj[0, 0] == 0.5 and tj[1, 1] == 0.5


def test_device_constants_are_cached_per_dtype_and_device():
    dc = tp.DeviceConstants(a=[1.0, 2.0])
    x64, x32 = torch.zeros(2, dtype=F64), torch.zeros(2, dtype=torch.float32)
    a64 = dc.on(x64)["a"]
    assert dc.on(x64)["a"] is a64 and a64.dtype == F64
    a32 = dc.on(x32)["a"]
    assert a32.dtype == torch.float32 and a32 is not a64
    # Rounded once from the float64 host value.
    third = tp.DeviceConstants(v=1 / 3).on(x32)["v"]
    assert third.item() == float(np.float32(1 / 3))
