"""The port's problem zoo vs zfista_tpu.models, float64 on the CPU.

Values, Jacobians, ``g`` (``+inf`` outside the box) and the weighted-sum
prox of every problem of the benchmark harness's list, built in the port
with ``interop.problem_from_spec``; analytic Jacobians against
``torch.func.jacfwd``; names identical to JAX (the harness's cache keys);
shape validation; array bounds in ``g``; ``solve_batch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zfista_tpu.models as jm
from zfista_tpu.bench.harness import initialize_problems
from zfista_tpu_torch import models as tm
from zfista_tpu_torch.interop import problem_from_spec

F64 = torch.float64
HARNESS = initialize_problems(large=False)
EXTRA = [
    (jm.ZDT1(n_features=7), 0.01, 1.0),
    (jm.LinearFunctionRank1(n_features=6, n_objectives=3), -1.0, 1.0),
    (jm.JOS1(n_features=4, l1_ratios=[0.1, 0.2], bounds=(-1.0, 3.0)), -1.0, 3.0),
]
CASES = HARNESS + EXTRA


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0].name)
def test_values_jacobians_g_and_prox_match_jax(case):
    jp, lo, hi = case
    tp = problem_from_spec(jp)
    assert type(tp).__name__ == type(jp).__name__ and tp.name == jp.name
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.uniform(lo, hi, jp.n_features)
        xj, xt = jnp.asarray(x), _t(x)
        np.testing.assert_allclose(tp.f(xt).numpy(), np.asarray(jp.f(xj)), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tp.jac_f(xt).numpy(), np.asarray(jp.jac_f(xj)), rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(tp.g(xt).numpy(), np.asarray(jp.g(xj)), rtol=1e-12, atol=1e-12)
        w = rng.uniform(0, 1, jp.n_objectives)
        w = 0.3 * w / w.sum()
        np.testing.assert_allclose(
            tp.prox_wsum_g(_t(w), xt).numpy(),
            np.asarray(jp.prox_wsum_g(jnp.asarray(w), xj)),
            rtol=0,
            atol=1e-15,
        )


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0].name)
def test_analytic_jacobian_equals_autodiff(case):
    jp, lo, hi = case
    tp = problem_from_spec(jp)
    x = _t(np.random.default_rng(1).uniform(lo, hi, jp.n_features))
    auto = torch.func.jacfwd(tp.f)(x)
    np.testing.assert_allclose(tp.jac_f(x).numpy(), auto.numpy(), rtol=1e-12, atol=1e-12)
    # The base class's default jac_f is the same autodiff.
    np.testing.assert_array_equal(tm.Problem.jac_f(tp, x).numpy(), auto.numpy())


def test_names_match_jax():
    pairs = [
        (jm.JOS1(), tm.JOS1()),
        (jm.JOS1(l1_ratios=[0.2, 0.1]), tm.JOS1(l1_ratios=[0.2, 0.1])),
        (jm.SD(), tm.SD()),
        (jm.ZDT1(), tm.ZDT1()),
        (jm.FDS(bounds=(0.0, np.inf)), tm.FDS(bounds=(0.0, np.inf))),
        (jm.TOI4(l1_ratios=[0.25, 0.25], l1_shifts=[0.0, 0.0]), tm.TOI4(l1_ratios=[0.25, 0.25], l1_shifts=[0.0, 0.0])),
        (jm.TRIDIA(), tm.TRIDIA()),
        (jm.LinearFunctionRank1(n_objectives=3), tm.LinearFunctionRank1(n_objectives=3)),
    ]
    for j, t in pairs:
        assert t.name == j.name and repr(t) == repr(j)
    assert tm.JOS1().name == "JOS1_n_5"
    assert [problem_from_spec(p).name for p, _, _ in HARNESS] == [p.name for p, _, _ in HARNESS]


@pytest.mark.parametrize("cls", [tm.SD, tm.ZDT1, tm.FDS])
def test_g_is_inf_outside_the_box(cls):
    p = cls() if cls is not tm.FDS else cls(bounds=(0.0, np.inf))
    x = torch.full((p.n_features,), 0.5, dtype=F64)
    assert torch.all(torch.isfinite(p.g(x)))
    x_out = x.clone()
    x_out[1] = -0.1
    assert torch.all(torch.isinf(p.g(x_out))) and torch.all(p.g(x_out) > 0)
    # The prox projects back inside.
    y = p.prox_wsum_g(torch.full((p.n_objectives,), 0.1, dtype=F64), x_out)
    assert torch.all(torch.isfinite(p.g(y)))


def test_shape_validation_and_unported_batch():
    with pytest.raises(ValueError, match="l1_ratios must have shape"):
        tm.FDS(l1_ratios=[0.1, 0.1])
    with pytest.raises(ValueError, match="l1_ratios must have shape"):
        tm.JOS1(l1_ratios=[[0.1], [0.1]])
    with pytest.raises(ValueError, match="l1_shifts must have shape"):
        tm.JOS1(l1_ratios=[0.1, 0.1], l1_shifts=[0.0])
    with pytest.raises(ValueError, match="l1_ratios must have shape"):
        tm.TOI4(l1_ratios=0.1)
    # solve_batch is the batch solver: numpy starts go to the card by
    # default, or to device="cpu".
    res = tm.JOS1().solve_batch(np.zeros((2, 5)), device="cpu", nesterov=True)
    assert res.x.shape == (2, 5) and res.success.all()


@pytest.mark.parametrize("point", ["feasible", "infeasible"])
def test_array_bounds_in_g_match_jax(point):
    """Bounds given as arrays (one per coordinate) reach ``g`` as device
    constants, as the prox takes them; ``g`` equals the JAX ``g``."""
    n = 3
    bounds = (np.full(n, -2.0), np.array([2.0, 1.0, 2.0]))
    jp = jm.JOS1(n_features=n, l1_ratios=[0.5, 0.25], bounds=bounds)
    tp = tm.JOS1(n_features=n, l1_ratios=[0.5, 0.25], bounds=bounds)
    x = np.array([0.5, 0.5, -1.0]) if point == "feasible" else np.array([0.5, 1.5, -1.0])
    got = tp.g(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.g(jnp.asarray(x))))
    assert np.isfinite(got).all() == (point == "feasible")
    # Scalar bounds: the same g as the same box given per coordinate.
    ts = tm.JOS1(n_features=n, l1_ratios=[0.5, 0.25], bounds=(-2.0, 1.0))
    tv = tm.JOS1(n_features=n, l1_ratios=[0.5, 0.25], bounds=(np.full(n, -2.0), np.ones(n)))
    for dt in (F64, torch.float32):
        xt = _t(x).to(dt)
        assert torch.equal(ts.g(xt), tv.g(xt))


def test_problem_from_spec_refuses_what_it_cannot_build():
    class Unknown:
        n_features, n_objectives = 3, 2
        _l1_ratios_raw = _l1_shifts_raw = bounds = None

    with pytest.raises(ValueError, match="no zoo problem"):
        problem_from_spec(Unknown())
    sd = jm.SD()
    sd.bounds = (0.0, 1.0)  # the port's SD constructor fixes its bounds
    sd.name = sd._generate_name()
    with pytest.raises(ValueError, match="cannot reproduce"):
        problem_from_spec(sd)


def test_constants_follow_the_tensor_dtype_and_device():
    """Float32 calls get float32 constants rounded once from float64, and
    repeated calls reuse the cached tensors (no per-call transfer)."""
    p = tm.SD()
    x32 = torch.full((4,), 1.5, dtype=torch.float32)
    assert p.f(x32).dtype == torch.float32 and p.jac_f(x32).dtype == torch.float32
    c = p._c.on(x32)
    assert p._c.on(x32) is c
    assert c["c1"][1].item() == float(np.float32(np.sqrt(2.0)))
    x64 = x32.to(F64)
    np.testing.assert_allclose(
        p.f(x64).numpy(), np.asarray(jm.SD().f(jnp.asarray(x64.numpy()))), rtol=1e-15
    )
