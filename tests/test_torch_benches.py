"""The port's wall-to-gap and restart benches against the JAX package's.

* ``gap_bench.run(m=160, n=64, chunk=16, max_chunks=48, repeats=1)``: both
  targets reached at the JAX run's iteration counts (float64, the JAX
  run's precision under x64), with the same F*; the CLI;
* ``restart_bench.bench_tridia_batch(repeats=1, n_lanes=4)``: its rows
  against the JAX rows.  The bench's starts are float32.  Without restart
  every count matches; with restart the number of converged lanes matches,
  and one lane's outer count does not (JAX 5, the port 8): in float32 the
  m=3 Newton dual's inner counts already differ without restart (the
  stall test sits at the rounding floor), which moves where the restart
  fires.  The same starts in float64 match lane for lane in the m>=3
  parity class, restart or not.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import json
import warnings

import numpy as np
import pytest
import torch

from zfista_tpu.bench import gap_bench as jg
from zfista_tpu.bench import restart_bench as jr
from zfista_tpu.models.zoo import TRIDIA as JTRIDIA
from zfista_tpu.parallel.batch import minimize_proximal_gradient_batch as j_batch
from zfista_tpu_torch.bench import gap_bench as tg
from zfista_tpu_torch.bench import restart_bench as tr
from zfista_tpu_torch.models.zoo import TRIDIA
from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch as t_batch

GAP = dict(m=160, n=64, chunk=16, max_chunks=48, repeats=1)


@pytest.fixture(scope="module")
def gap_records():
    j = jg.run(unroll=4, **GAP)
    t = tg.run(device="cpu", dtype=torch.float64, **GAP)
    return j, t


def test_gap_bench_reaches_both_targets_at_the_jax_counts(gap_records):
    j, t = gap_records
    assert t["F_star"] == pytest.approx(j["F_star"], rel=1e-12)
    rows_j = {r["target"]: r for r in j["rows"]}
    rows_t = {r["target"]: r for r in t["rows"]}
    assert rows_t.keys() == rows_j.keys() == {1e-6, 1e-8}
    for target in rows_j:
        assert rows_t[target]["iterations"] == rows_j[target]["iterations"] is not None
        assert rows_t[target]["raw_s"] > 0 and rows_t[target]["public_s"] > 0
    assert rows_t[1e-8]["iterations"] >= rows_t[1e-6]["iterations"]
    assert t["backend"] == "cpu" and t["metric"] == j["metric"]


def test_gap_bench_problem_is_the_jax_one():
    for a, b in zip(tg.make_problem(30, 20), jg.make_problem(30, 20)):
        np.testing.assert_array_equal(a, b)
    A, _, _ = tg.make_problem(30, 20)
    assert tg.lipschitz_np(A) == jg.lipschitz_np(A)


def test_gap_bench_cli(capsys):
    tg.main(["--m", "60", "--n", "20", "--chunk", "8", "--max-chunks", "4", "--repeats", "1",
             "--unroll", "2", "--targets", "1e-3", "--device", "cpu", "--dtype", "float64"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "lasso_wall_to_gap" and rec["rows"][0]["target"] == 1e-3


def test_gap_bench_validates_and_goes_to_the_card_by_default(monkeypatch):
    with pytest.raises(ValueError, match="repeats/chunk/max_chunks"):
        tg.run(repeats=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.run(m=10, n=5)


@pytest.fixture(scope="module")
def tridia_rows():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jr.bench_tridia_batch(1, n_lanes=4), tr.bench_tridia_batch(1, n_lanes=4, device="cpu")


def test_restart_tridia_rows(tridia_rows):
    j, t = tridia_rows
    assert [(r["problem"], r["restart"]) for r in t] == [(r["problem"], r["restart"]) for r in j]
    off_j, on_j = j
    off_t, on_t = t
    for key in ("nit", "nit_max", "n_converged"):
        assert off_t[key] == off_j[key], key
    assert on_t["n_converged"] == on_j["n_converged"]
    assert all(r["wall_s"] > 0 for r in t)


@pytest.mark.parametrize("restart", [False, True])
def test_restart_tridia_batch_float64_lane_for_lane(restart):
    """The bench's starts in float64: the m>=3 parity class lane for lane
    (equal nit and status, x within 1e-9, inner counts within 25%)."""
    X0 = np.random.default_rng(42).uniform(-1.0, 1.0, size=(4, 3)).astype(np.float32)
    X0 = X0.astype(np.float64)
    kw = dict(nesterov=True, tol=1e-6, max_iter=10000, check_every=64, adaptive_restart=restart)
    pj, pt = JTRIDIA(), TRIDIA()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = j_batch(pj.f, pj.g, pj.jac_f, pj.prox_wsum_g, X0, **kw)
        b = t_batch(pt.f, pt.g, pt.jac_f, pt.prox_wsum_g, X0, device="cpu", **kw)
    for key in ("nit", "status"):
        np.testing.assert_array_equal(b[key], np.asarray(a[key]), err_msg=key)
    np.testing.assert_allclose(b.x, np.asarray(a.x), rtol=0, atol=1e-9)
    inner_j = np.asarray(a.nit_internal)
    assert np.all(np.abs(b.nit_internal - inner_j) <= 0.25 * inner_j)


def test_restart_main_and_timed(capsys):
    tr.main(["--skip", "lasso,tv,tridia", "--device", "cpu"])
    assert capsys.readouterr().out.strip() == "backend: cpu"
    with pytest.raises(ValueError, match="repeats"):
        tr._timed(lambda: None, 0)
    res, wall = tr._timed(lambda: 7, 2)
    assert res == 7 and wall >= 0
