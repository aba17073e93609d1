"""The port's momentum sweep against the JAX package's, on the CPU.

* rows on JOS1 n=5 from 8 starts: equal ``nit`` per pair and equal
  ``error_rate``; measured times; the ``x0s`` override and its shape check;
* ``write_ab_csv``: byte-equal to the JAX writer's for the same rows;
* ``lane_chunk`` bitwise against no chunking (a ragged last chunk).
"""

import torch_env  # noqa: F401  (one torch thread a process)
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

from zfista_tpu.bench import momentum_sweep as jm
from zfista_tpu.models.zoo import JOS1 as JJOS1
from zfista_tpu_torch.bench import momentum_sweep as tm
from zfista_tpu_torch.models.zoo import JOS1, SD


@pytest.fixture(scope="module")
def sweeps():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        j, _ = jm.momentum_sweep(JJOS1(n_features=5), -2, 4, n_starts=8, max_iter=5000,
                                 measure_times=False)
        t, res = tm.momentum_sweep(JOS1(n_features=5), -2, 4, n_starts=8, max_iter=5000,
                                   measure_times=False, device="cpu")
    return j, t, res


def test_grid_matches_jax():
    assert tm.AB_GRID == jm.AB_GRID and len(tm.AB_GRID) == 15


def test_rows_match_jax(sweeps):
    j, t, res = sweeps
    assert [(r["a"], r["b"]) for r in t] == [(r["a"], r["b"]) for r in j]
    for a, b in zip(j, t):
        assert b["nit"] == a["nit"] and b["error_rate"] == a["error_rate"], (a, b)
        assert b["time"] > 0
    # the shared sweep: grid-major lanes, each with its own pair
    assert res.x.shape == (15 * 8, 5)
    np.testing.assert_array_equal(res.nesterov_ratio[8], [0.0, 0.125])


def test_measured_times_and_x0_override():
    x0s = np.random.default_rng(3).uniform(1, 2, size=(4, 4))
    grid = tm.AB_GRID[:2]
    rows, res = tm.momentum_sweep(SD(), 1, 2, n_starts=4, ab_grid=grid, x0s=x0s,
                                  device="cpu")
    assert len(rows) == 2 and all(r["time"] > 0 for r in rows)
    np.testing.assert_array_equal(res.x0[:4], x0s)
    with pytest.raises(ValueError, match="x0s must be"):
        tm.momentum_sweep(SD(), 1, 2, n_starts=3, x0s=x0s, device="cpu")


def test_write_ab_csv_byte_equal_to_jax(tmp_path):
    rows = [
        dict(a=str(a), b=str(b), time=t, nit=n, error_rate=0.0)
        for (a, b), t, n in zip(
            jm.AB_GRID,
            [0.0, 0.25, 0.1, 0.0999, 7.3e-5, 5.1e-4, 1.234e-6, None, 2.0, 0.5e-3,
             0.00999, 1e-9, 0.123456, 3.3e-2, 42.0],
            [97.0, 81.0934, None, 65, 1.0, 2.3456, 113.4729, None, 0.0, 1e3,
             5.5, 6.25, 7.125, 8.0625, 9.03125],
        )
    ]
    jm.write_ab_csv(rows, tmp_path / "jax.csv")
    tm.write_ab_csv(rows, tmp_path / "port" / "t.csv")
    assert (tmp_path / "port" / "t.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert (tmp_path / "jax.csv").read_text().splitlines()[0] == "0 ,0,0.000,97.0"


def test_lane_chunk_bitwise():
    """15 pairs x 16 starts = 240 lanes in chunks of 32 (a ragged last
    chunk of 16, padded), bitwise the unchunked sweep.  (Lanes x n stay a
    multiple of 16 in float64: the CPU's vectorized pow rounds differently
    in a kernel's scalar tail.)"""
    p = JOS1(n_features=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        whole, r1 = tm.momentum_sweep(p, -2, 4, n_starts=16, max_iter=5000,
                                      measure_times=False, device="cpu")
        chunked, r2 = tm.momentum_sweep(p, -2, 4, n_starts=16, max_iter=5000,
                                        measure_times=False, lane_chunk=32, device="cpu")
    assert [r["nit"] for r in chunked] == [r["nit"] for r in whole]
    for key in ("x", "nit", "nit_internal", "status", "fun"):
        np.testing.assert_array_equal(r2[key], r1[key], err_msg=key)


def test_sweep_goes_to_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.momentum_sweep(SD(), 1, 2, n_starts=2, ab_grid=[(Fraction(0), Fraction(0))],
                          measure_times=False)
