"""The port's Pareto metrics and native kernels against the JAX package's.

* ``non_dominated_mask``, ``hypervolume`` (``front_true`` and
  ``ref_point`` forms) and ``spread_metrics`` on seeded fronts with m = 2,
  3 and 4 objectives, plus rows with NaN, ±inf and duplicates: equal to
  the JAX module's results exactly, at sizes on both sides of the native
  thresholds (mask over 512 points, volume over 64);
* ``calculate_metrics`` on the same synthetic result lists in both
  packages: equal dicts;
* the port's native kernels against its own numpy paths.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest

from zfista_tpu import metrics as jm
from zfista_tpu.core.result import SolveResult as JResult
from zfista_tpu_torch import metrics as tm
from zfista_tpu_torch import native
from zfista_tpu_torch.core.result import SolveResult as TResult


def _front(m: int, n: int, seed: int) -> np.ndarray:
    """Seeded points with duplicates, a NaN row, a +inf and a -inf entry."""
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.0, 1.0, size=(n, m))
    F[1] = F[0]  # duplicate
    F[2, 0] = np.nan
    F[3, m - 1] = np.inf
    F[4, 0] = -np.inf
    return F


def _ball_front(m: int, n: int, seed: int) -> np.ndarray:
    """Points on the positive unit sphere: every one non-dominated."""
    rng = np.random.default_rng(seed)
    P = np.abs(rng.standard_normal((n, m)))
    return 1.0 - P / np.linalg.norm(P, axis=1, keepdims=True) * 0.9


def _numpy_nd_mask(F):
    le = np.all(F[:, None, :] <= F[None, :, :], axis=-1)
    lt = np.any(F[:, None, :] < F[None, :, :], axis=-1)
    return ~(le & lt).any(axis=0)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n", [40, 700])
def test_non_dominated_mask_matches_jax(m, n):
    F = _front(m, n, seed=10 * m + n)
    np.testing.assert_array_equal(tm.non_dominated_mask(F), jm.non_dominated_mask(F))
    np.testing.assert_array_equal(
        tm.extract_non_dominated_points(F), jm.extract_non_dominated_points(F)
    )


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n", [30, 120])
def test_hypervolume_matches_jax(m, n):
    F = _ball_front(m, n, seed=m + n)
    F[0] = F[1]  # duplicate
    F[2, 0] = np.nan
    F[3, 0] = np.inf
    front_true = _ball_front(m, 50, seed=99)
    assert tm.hypervolume(F, front_true=front_true) == jm.hypervolume(F, front_true=front_true)
    ref = np.full(m, 1.05)
    assert tm.hypervolume(F, ref_point=ref) == jm.hypervolume(F, ref_point=ref)
    with pytest.raises(ValueError, match="front_true or ref_point"):
        tm.hypervolume(F)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_spread_and_purity_match_jax(m):
    front_true = _ball_front(m, 60, seed=7)
    for front in (front_true[:25], front_true[:1], np.empty((0, m))):
        assert tm.spread_metrics(front, front_true) == jm.spread_metrics(front, front_true)
        assert tm.purity(front, front_true) == jm.purity(front, front_true)


def _results(cls, m: int, n: int, seed: int, fail: int = 0, nonfinite: bool = False):
    rng = np.random.default_rng(seed)
    funs = _ball_front(m, n, seed)
    if nonfinite:
        funs[0, 0] = np.nan
        funs[1, -1] = np.inf
    out = []
    for i in range(n):
        out.append(
            cls(
                fun=funs[i],
                x=rng.standard_normal(3),
                success=i >= fail,
                nit=int(rng.integers(5, 50)),
                nit_internal=int(rng.integers(50, 500)),
                time=float(rng.uniform(0.01, 0.1)),
            )
        )
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for metric in a:
        assert a[metric].keys() == b[metric].keys()
        for alg in a[metric]:
            x, y = a[metric][alg], b[metric][alg]
            assert x == y or (np.isnan(x) and np.isnan(y)), (metric, alg, x, y)


@pytest.mark.parametrize(
    "case",
    ["m2", "m3_with_failures", "nonfinite_rows", "all_failed_variant"],
)
def test_calculate_metrics_matches_jax(case):
    m = 3 if case == "m3_with_failures" else 2
    specs = {
        "m2": [dict(seed=1), dict(seed=2), dict(seed=3)],
        "m3_with_failures": [dict(seed=4, fail=3), dict(seed=5)],
        "nonfinite_rows": [dict(seed=6, nonfinite=True), dict(seed=7)],
        "all_failed_variant": [dict(seed=8, fail=20), dict(seed=9)],
    }[case]
    named = {}
    for cls in (JResult, TResult):
        named[cls] = [(f"alg{k}", _results(cls, m, 20, **kw)) for k, kw in enumerate(specs)]
    mj, rj = jm.calculate_metrics(*named[JResult])
    mt, rt = tm.calculate_metrics(*named[TResult])
    _assert_same(mt, mj)
    _assert_same(rt, rj)


def test_native_loads_and_equals_numpy_paths():
    """The port's C++ kernels (built from its own copy of metrics.cpp)
    against its numpy paths, as tests/test_native_metrics.py checks the JAX
    package's."""
    assert native.load() is not None
    rng = np.random.default_rng(3)
    for m in (2, 3, 4):
        F = rng.uniform(0, 1, size=(800, m))
        F[5] = F[4]
        np.testing.assert_array_equal(native.nd_mask_native(F), _numpy_nd_mask(F))
    for m in (2, 3):
        P = _ball_front(m, 90, seed=m)
        ref = np.ones(m)
        np.testing.assert_allclose(
            native.hypervolume_native(P, ref),
            float(tm._wfg(P[tm.non_dominated_mask(P)], ref)),
            rtol=1e-12,
        )


def test_native_build_is_the_ports_own():
    """The object is built from the port's source into the port's _build/,
    never the JAX package's."""
    lib = native.load()
    assert "zfista_tpu_torch/native/_build/zt_metrics_" in lib._name
    assert (native._SRC).read_bytes().count(b"zt_nd_mask") >= 1
