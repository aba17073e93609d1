"""The port's example scripts and kernel benches as a user runs them:
``python -m zfista_tpu_torch.examples.<name>`` at a tiny size with
``--device cpu``, in a subprocess whose working directory is a temporary
one.  Each writes only there (the scripts that write files do so under
``--out``, default ``bench_results/torch/``) and imports nothing of JAX.
The two kernel benches exit with status 1 and a message without a card."""

import torch_env  # noqa: F401  (one torch thread a process)
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(module, args, cwd, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}, *{list(args)!r}]\n"
        f"runpy.run_module({module!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'zfista_tpu')\n"
        "             or m.startswith(('jax.', 'zfista_tpu.')))\n"
        "if bad:\n"
        "    print('imported', bad, file=sys.stderr)\n"
        "    raise SystemExit(3)\n"
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=cwd)


def _files(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file())


def test_cameraman_deblur_writes_under_the_default_out(tmp_path):
    r = _run("zfista_tpu_torch.examples.cameraman_deblur",
             ["--size", "16", "--max-iter", "60", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    out = tmp_path / "bench_results" / "torch"
    assert (out / "cameraman_ab.csv").exists()
    assert all(f.startswith("bench_results/torch/") for f in _files(tmp_path))
    rows = (out / "cameraman_ab.csv").read_text().splitlines()
    assert len(rows) == 15 and rows[0].startswith("0 ,0,")
    assert "15 pairs on cpu" in r.stdout


def test_tv_deblur(tmp_path):
    r = _run("zfista_tpu_torch.examples.tv_deblur",
             ["--size", "32", "--max-iter", "30", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TV (warm)" in r.stdout and "waveletL1" in r.stdout
    assert _files(tmp_path) == []


def test_momentum_experiment(tmp_path):
    out = tmp_path / "ab"
    r = _run("zfista_tpu_torch.examples.momentum_experiment",
             ["--n-starts", "2", "--max-iter", "10", "--out", str(out), "--device", "cpu"],
             tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _files(tmp_path) == sorted(
        f"ab/{name}_ab.csv" for name in ("JOS1", "JOS1_L1", "SD", "FDS", "FDS_CONSTRAINED")
    )


def test_optimality_gap(tmp_path):
    import json

    r = _run("zfista_tpu_torch.examples.optimality_gap",
             ["--n", "256", "--m", "32", "--refine-iters", "20", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "lasso_n10k_wall_to_gap" and rec["device"] == "cpu"
    assert [c["iters"] for c in rec["checkpoints"]] == [250, 500, 1000, 2000, 4000]
    # the public path and the raw loop compute the same iterates
    for a, b in zip(rec["checkpoints"], rec["public_checkpoints"]):
        assert a["gap"] == pytest.approx(b["gap"], rel=1e-6, abs=1e-12)
    assert _files(tmp_path) == []


@pytest.mark.parametrize("bench", ["kernels", "tv_bench"])
def test_benches_need_a_card(tmp_path, bench):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"zfista_tpu_torch.bench.{bench}"],
                       capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_large_lasso(tmp_path):
    """The n = 10⁶ example at a tiny size: one JSON line with the JAX
    script's keys (``warmup_s`` for ``compile_s``, and the device); its
    steps are the plain torch loop's, bitwise, and the JAX package's
    ``fista_step_dense`` loop's within 1e-10 in float64."""
    import json

    import jax.numpy as jnp
    import numpy as np
    import torch

    from zfista_tpu.models.lasso import fista_step_dense as j_step
    from zfista_tpu_torch.examples import large_lasso
    from zfista_tpu_torch.models.lasso import fista_step_dense as t_step

    r = _run("zfista_tpu_torch.examples.large_lasso",
             ["--device", "cpu", "--n", "4096", "--m", "64", "--iters", "5"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "n", "m", "model_shards", "value", "unit", "achieved_GBps",
                        "warmup_s", "final_obj", "device"}
    assert (rec["metric"], rec["n"], rec["m"], rec["model_shards"], rec["unit"], rec["device"]) == (
        "large_lasso_iterations_per_s", 4096, 64, 1, "iter/s", "cpu")
    assert np.isfinite(rec["final_obj"]) and rec["value"] > 0
    assert _files(tmp_path) == []

    # A spans several generator blocks (3 at n = 20,000).
    A, b = large_lasso.build_operator(64, 20_000, 0, None, "cpu", torch.float64)
    lr_v = 1.0 / float(2 * np.linalg.norm(A.numpy(), 2) ** 2)
    lam, lr = torch.tensor(0.01, dtype=torch.float64), torch.tensor(lr_v, dtype=torch.float64)
    x0 = torch.zeros(20_000, dtype=torch.float64)
    x, y, t = large_lasso.iterate(A, b, lam, lr, x0, 5)
    c = (x0, x0, torch.ones((), dtype=torch.float64))
    for _ in range(5):
        c = t_step(A, b, lam, lr, c)
    assert torch.equal(x, c[0]) and torch.equal(y, c[1]) and torch.equal(t, c[2])
    jA, jb = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())
    jc = (jnp.zeros(20_000), jnp.zeros(20_000), jnp.ones(()))
    for _ in range(5):
        jc = j_step(jA, jb, jnp.asarray(0.01), jnp.asarray(lr_v), jc)
    np.testing.assert_allclose(x.numpy(), np.asarray(jc[0]), rtol=0, atol=1e-10)
    # Every shard count holds the same A: a block is the same columns.
    from zfista_tpu_torch.parallel.sharding import make_mesh, operator_sharding

    A1, _ = large_lasso.build_operator(64, 20_000, 0, operator_sharding(make_mesh()), "cpu",
                                       torch.float64)
    assert torch.equal(A1, A)
