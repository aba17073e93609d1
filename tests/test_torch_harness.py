"""The port's benchmark harness against the JAX package's, on the CPU.

* ``initialize_problems`` (small and large): the same names, boxes, sizes
  and bounds as the JAX lists;
* ``benchmark`` on JOS1 n=5 (4 starts, ``max_iter=2000``): per lane equal
  ``nit``/``status``, x within 1e-10; the metrics of both within 1e-10
  (time excluded) and equal performance profiles;
* the cache: a hit, the invalidation warning, an array- and a
  tensor-valued kwarg, and a cell the JAX harness wrote, refused and re-run
  with a warning without importing JAX;
* ``main(["--device", "cpu", ...])`` over a small sweep with the plots
  drawn, a second run served from the cache with byte-identical
  ``metrics.json``, and the ImportError without matplotlib.

The JAX batches are solved once per module (a vmapped JAX program takes
seconds to compile on the CPU).
"""

import torch_env  # noqa: F401  (one torch thread a process)
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from zfista_tpu.bench import harness as jh
from zfista_tpu.metrics import calculate_metrics as j_metrics
from zfista_tpu.models.zoo import JOS1 as JJOS1
from zfista_tpu_torch.bench import harness as th
from zfista_tpu_torch.metrics import calculate_metrics as t_metrics
from zfista_tpu_torch.models.zoo import JOS1, SD, TRIDIA

ROOT = Path(__file__).resolve().parent.parent
KW = dict(n_samples=4, max_iter=2000)


@pytest.fixture(scope="module")
def runs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        j = jh.benchmark(JJOS1(n_features=5), -2.0, 4.0, **KW)
        t = th.benchmark(JOS1(n_features=5), -2.0, 4.0, device="cpu", **KW)
    return j, t


@pytest.mark.parametrize("large", [False, True])
def test_initialize_problems_match_jax(large):
    j = jh.initialize_problems(large=large)
    t = th.initialize_problems(large=large)
    assert len(t) == len(j)
    for (pj, lj, hj), (pt, lt, ht) in zip(j, t):
        assert type(pt).__name__ == type(pj).__name__
        assert (pt.name, lt, ht) == (pj.name, lj, hj)
        assert (pt.n_features, pt.n_objectives, pt.bounds) == (
            pj.n_features, pj.n_objectives, pj.bounds,
        )


def test_variants_match_jax():
    assert th.VARIANTS == jh.VARIANTS
    assert th.PROJECTED_VARIANT == jh.PROJECTED_VARIANT
    for p in (JOS1(n_features=5), SD()):
        assert th._effective_variants(p, None) == jh._effective_variants(p, None)
    assert th._effective_variants(SD(), {"A": {}}) == {"A": {}}


def test_benchmark_lanes_match_jax(runs):
    j, t = runs
    assert list(t) == list(j) == list(jh.VARIANTS)
    for v in j:
        assert len(t[v]) == KW["n_samples"]
        for a, b in zip(j[v], t[v]):
            assert (b.nit, b.status, b.nit_internal) == (a.nit, a.status, a.nit_internal)
            np.testing.assert_allclose(b.x, np.asarray(a.x), rtol=0, atol=1e-10)
            # host values only: a result holds no tensor
            assert not any(isinstance(val, torch.Tensor) for val in b.values())
            assert len(b.allfuns) == b.nit + 1 and len(b.allerrs) == b.nit


def _close(a, b, tol=1e-10):
    return a == b or (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol * max(abs(a), abs(b))


def test_metrics_and_profiles_match_jax(runs):
    j, t = runs
    mj, rj = j_metrics(*j.items())
    mt, rt = t_metrics(*t.items())
    for metric in mj:
        if metric == "Avg computation time":
            continue
        for alg in mj[metric]:
            assert _close(mt[metric][alg], mj[metric][alg]), (metric, alg)
            assert _close(rt[metric][alg], rj[metric][alg]), (metric, alg)
    pj = jh.performance_profiles({"JOS1_n_5": rj, "copy": rj})
    pt = th.performance_profiles({"JOS1_n_5": rt, "copy": rt})
    for metric in pj:
        if metric == "Avg computation time":
            continue
        for alg in pj[metric]:
            np.testing.assert_allclose(pt[metric][alg][0], pj[metric][alg][0], rtol=1e-10)
            np.testing.assert_array_equal(pt[metric][alg][1], pj[metric][alg][1])


def test_performance_profiles_shape():
    ratios_all = {
        "p1": {"Avg iterations": {"A": 1.0, "B": 2.0}},
        "p2": {"Avg iterations": {"A": 1.5, "B": np.nan}},
    }
    got = th.performance_profiles(ratios_all)
    want = jh.performance_profiles(ratios_all)
    for alg in ("A", "B"):
        for g, w in zip(got["Avg iterations"][alg], want["Avg iterations"][alg]):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got["Avg iterations"]["B"][1], [0.5])


def _cell(tmp_path, **kw):
    return th.load_or_run_results(
        JOS1(n_features=5), -2.0, 4.0, tmp_path, device="cpu", history=False, **kw
    )


def _caught(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught if "re-running" in str(w.message)]


def test_cache_hit_and_invalidation(tmp_path, monkeypatch):
    r1 = _cell(tmp_path, n_samples=3, max_iter=50)
    assert (tmp_path / "JOS1_n_5.pkl").exists()
    calls = []
    real = th.benchmark
    monkeypatch.setattr(th, "benchmark", lambda *a, **k: calls.append(1) or real(*a, **k))
    again, msgs = _caught(_cell, tmp_path, n_samples=3, max_iter=50)
    assert calls == [] and msgs == []
    np.testing.assert_array_equal(again["Normal"][0].x, r1["Normal"][0].x)
    r2, msgs = _caught(_cell, tmp_path, n_samples=3, max_iter=200)
    assert calls == [1] and len(msgs) == 1 and "different settings" in msgs[0]
    assert max(r.nit for r in r2["Accelerated"]) <= 200
    _, msgs = _caught(_cell, tmp_path, n_samples=3, max_iter=200)
    assert calls == [1] and msgs == []


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_cache_config_with_array_kwarg(tmp_path, kind):
    ratio = np.array([0.5, 0.25]) if kind == "ndarray" else torch.tensor([0.5, 0.25])
    variants = {"Acc": dict(nesterov=True, nesterov_ratio=ratio)}
    r1 = _cell(tmp_path, n_samples=2, max_iter=500, variants=variants)
    r2, msgs = _caught(_cell, tmp_path, n_samples=2, max_iter=500, variants=variants)
    assert msgs == []
    np.testing.assert_array_equal(r1["Acc"][0].x, r2["Acc"][0].x)
    assert th._canonical_config({"r": torch.tensor([0.5, 0.25], dtype=torch.float64)}) == (
        th._canonical_config({"r": np.array([0.5, 0.25])})
    )


def test_jax_written_cell_is_refused_and_rerun(tmp_path):
    """A cell the JAX harness pickled (zfista_tpu SolveResults) is not
    unpickled: the port warns, re-runs and overwrites it, and no JAX module
    is imported (checked in a fresh interpreter)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jh.load_or_run_results(
            JJOS1(n_features=5), -2.0, 4.0, tmp_path, n_samples=2, max_iter=20, history=False
        )
    code = (
        "import sys, warnings\n"
        "from pathlib import Path\n"
        "from zfista_tpu_torch.bench import harness\n"
        "from zfista_tpu_torch.models.zoo import JOS1\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        f"    r = harness.load_or_run_results(JOS1(n_features=5), -2.0, 4.0, Path({str(tmp_path)!r}),\n"
        "        device='cpu', n_samples=2, max_iter=20, history=False)\n"
        "msgs = [str(x.message) for x in w if 're-running' in str(x.message)]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'zfista_tpu'))\n"
        "print(len(msgs), type(r['Normal'][0]).__module__, bad)\n"
        "raise SystemExit(0 if len(msgs) == 1 and not bad and 'cannot be read' in msgs[0] else 1)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "zfista_tpu_torch.core.result" in out.stdout
    # The re-run overwrote the cell: the port now reads it silently.
    again, msgs = _caught(_cell, tmp_path, n_samples=2, max_iter=20)
    assert msgs == [] and len(again["Normal"]) == 2


def _small_sweep(*, large=False):
    return [(JOS1(n_features=5), -2.0, 4.0), (SD(), 1.0, 2.0), (TRIDIA(), -1.0, 1.0)]


def test_main_on_the_cpu_with_plots(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setattr(th, "initialize_problems", _small_sweep)
    argv = ["--device", "cpu", "--n-samples", "3", "--max-iter", "15", "--out", str(tmp_path)]
    th.main(argv)
    names = [p.name for p, _, _ in _small_sweep()]
    first = {}
    for name in names:
        for art in ("metrics.json", "pareto_front.pdf", "error_decay.pdf"):
            assert (tmp_path / name / art).stat().st_size > 0, (name, art)
        first[name] = (tmp_path / name / "metrics.json").read_bytes()
    assert (tmp_path / "cache" / f"{names[2]}.pkl").exists()
    assert len(list(tmp_path.glob("performance_profile_*.pdf"))) == 8
    table = (tmp_path / "metrics.csv").read_text().splitlines()
    assert table[0] == "problem,metric,algorithm,value"
    # 3 variants x 8 metrics (JOS1, TRIDIA) + 4 x 8 (SD, bounded)
    assert len(table) == 1 + 2 * 24 + 32
    # Second run: every cell a cache hit, the same metrics.json bytes.
    calls = []
    monkeypatch.setattr(th, "benchmark", lambda *a, **k: calls.append(1))
    th.main(argv + ["--no-plots"])
    assert calls == []
    for name in names:
        assert (tmp_path / name / "metrics.json").read_bytes() == first[name]


def test_main_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(th, "initialize_problems", lambda *, large=False: _small_sweep()[:1])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        th.main(["--device", "cpu", "--n-samples", "2", "--max-iter", "5", "--out", str(tmp_path)])
    th.main(["--device", "cpu", "--n-samples", "2", "--max-iter", "5", "--out", str(tmp_path), "--no-plots"])
    assert (tmp_path / "metrics.csv").exists()


def test_benchmark_goes_to_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.benchmark(JOS1(n_features=5), -2.0, 4.0, n_samples=2, max_iter=2)
