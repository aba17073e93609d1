"""The cells that only the benchmark suite's ``--large`` sweep runs, on the
port against the JAX package, on the CPU.

* Every large-only cell of ``initialize_problems(large=True)`` (JOS1 at
  n = 10 ... 1000, FDS at n = 5 ... 100, plain, ℓ1 and bounded, ZDT1 at
  n = 100): ``f``, ``jac_f`` and ``prox_wsum_g`` at seeded points of its
  sampling box against JAX x64, within 1e-10.
* ``benchmark`` on the two widest of them, FDS n = 100 bounded (m = 3) and
  JOS1 n = 1000 with ℓ1 (m = 2): 4 starts, the accelerated variant, 5
  iterations, in the batch classes (equal ``nit``, ``nit_internal`` at
  m = 2 and ``status``; x within 1e-10 at m = 2, 1e-6 at m = 3).  These
  are the file's two JAX compiles.
* ``runtests_torch.py``, the port's counterpart of ``runtests.py``: it
  imports no JAX, and without a card it exits 1 with the port's "no CUDA
  device" message before it writes anything.
"""

import torch_env
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.bench import harness as jh
from zfista_tpu_torch.bench import harness as th

F64 = torch.float64
ROOT = Path(__file__).resolve().parent.parent


def _large_only(harness):
    small = {p.name for p, _, _ in harness.initialize_problems(large=False)}
    return [c for c in harness.initialize_problems(large=True) if c[0].name not in small]


JAX_CELLS = {p.name: (p, lo, hi) for p, lo, hi in _large_only(jh)}
PORT_CELLS = {p.name: (p, lo, hi) for p, lo, hi in _large_only(th)}


def test_the_large_only_cells_are_the_jax_ones():
    assert list(PORT_CELLS) == list(JAX_CELLS)
    assert len(PORT_CELLS) == 25
    assert sum(name.startswith("JOS1") for name in PORT_CELLS) == 12
    assert sum(name.startswith("FDS") for name in PORT_CELLS) == 12


@pytest.mark.parametrize("name", sorted(PORT_CELLS))
def test_large_only_cell_matches_jax(name):
    pj, lo, hi = JAX_CELLS[name]
    pt, _, _ = PORT_CELLS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    for x in rng.uniform(lo, hi, size=(2, pt.n_features)):
        xt, xj = torch.tensor(x, dtype=F64), jnp.asarray(x)
        np.testing.assert_allclose(pt.f(xt).numpy(), np.asarray(pj.f(xj)), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(pt.jac_f(xt).numpy(), np.asarray(pj.jac_f(xj)),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(pt.g(xt).numpy(), np.asarray(pj.g(xj)), rtol=1e-10, atol=1e-10)
        w = rng.dirichlet(np.ones(pt.n_objectives))
        y = x + rng.normal(0.0, 0.5, x.shape)
        got = pt.prox_wsum_g(torch.tensor(w, dtype=F64), torch.tensor(y, dtype=F64)).numpy()
        np.testing.assert_allclose(got, np.asarray(pj.prox_wsum_g(jnp.asarray(w), jnp.asarray(y))),
                                   rtol=1e-10, atol=1e-10)


BENCH = dict(n_samples=4, max_iter=5, variants={"Accelerated": dict(nesterov=True)})


@pytest.mark.parametrize("name, atol", [
    ("FDS_n_100_bounds_0.0_inf", 1e-6),
    ("JOS1_n_1000_l1_ratios_0.001_0.002_l1_shifts_0.0_-1.0", 1e-10),
])
def test_benchmark_on_the_widest_cells_matches_jax(name, atol):
    pj, lo, hi = JAX_CELLS[name]
    pt, _, _ = PORT_CELLS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        j = jh.benchmark(pj, lo, hi, **BENCH)["Accelerated"]
        t = th.benchmark(pt, lo, hi, device="cpu", **BENCH)["Accelerated"]
    assert len(t) == len(j) == BENCH["n_samples"]
    for a, b in zip(j, t):
        assert (b.nit, b.status) == (a.nit, a.status)
        if pt.n_objectives <= 2:
            assert b.nit_internal == a.nit_internal
        np.testing.assert_allclose(b.x, np.asarray(a.x), rtol=0, atol=atol)
        assert len(b.allfuns) == b.nit + 1 and len(b.allerrs) == b.nit
        np.testing.assert_allclose(b.allfuns, a.allfuns, rtol=1e-10)


def _runtests(args, cwd):
    return subprocess.run([sys.executable, str(ROOT / "runtests_torch.py"), *args], cwd=cwd,
                          env=torch_env.child_env(), capture_output=True, text=True, timeout=120)


def test_runtests_torch_imports_no_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['runtests_torch.py', '--help']\n"
        "try:\n"
        f"    runpy.run_path({str(ROOT / 'runtests_torch.py')!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zfista_tpu'))\n"
        "assert 'zfista_tpu_torch.bench.harness' in sys.modules\n"
        "print('JAX_MODULES', bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=torch_env.child_env(PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_MODULES []" in r.stdout, r.stdout[-2000:]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-card exit needs a machine without a card")
def test_runtests_torch_without_a_card_exits_1(tmp_path):
    r = _runtests(["--no-plots", "--out", str(tmp_path / "out")], tmp_path)
    assert r.returncode == 1
    assert "zfista_tpu_torch: no CUDA device" in r.stderr, r.stderr[-2000:]
    assert not (tmp_path / "out").exists()
