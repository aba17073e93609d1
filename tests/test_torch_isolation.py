"""The PyTorch port stands alone: no JAX at import, a clean static gate,
and chip_smoke.py refusing to run without a CUDA device."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zfista_tpu_torch import interop
from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import deblur, lasso
from zfista_tpu_torch.parallel import distributed, minimize_proximal_gradient_batch
from zfista_tpu_torch.parallel.sharding import P, make_mesh
from zfista_tpu_torch.ops import precision

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import staticcheck  # noqa: E402


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import zfista_tpu_torch, zfista_tpu_torch.models, zfista_tpu_torch.interop\n"
        "import zfista_tpu_torch.ops.fused, zfista_tpu_torch.ops._build\n"
        "import zfista_tpu_torch.ops.tv, zfista_tpu_torch.ops.tv_cuda\n"
        "import zfista_tpu_torch.models.deblur, zfista_tpu_torch.models.zoo\n"
        "import zfista_tpu_torch.core.subproblem, zfista_tpu_torch.ops.prox\n"
        "import zfista_tpu_torch.parallel, zfista_tpu_torch.parallel.batch\n"
        "import zfista_tpu_torch.metrics, zfista_tpu_torch.native\n"
        "import zfista_tpu_torch.utils, zfista_tpu_torch.utils.checkpoint\n"
        "import zfista_tpu_torch.utils.profiling, zfista_tpu_torch.bench\n"
        "import zfista_tpu_torch.bench.harness, zfista_tpu_torch.bench.plots\n"
        "import zfista_tpu_torch.bench.momentum_sweep, zfista_tpu_torch.bench.gap_bench\n"
        "import zfista_tpu_torch.bench.restart_bench\n"
        "import zfista_tpu_torch.models.logistic, zfista_tpu_torch.models.lasso\n"
        "import zfista_tpu_torch.bench.kernels, zfista_tpu_torch.bench.tv_bench\n"
        "import zfista_tpu_torch.examples, zfista_tpu_torch.examples.cameraman_deblur\n"
        "import zfista_tpu_torch.examples.tv_deblur, zfista_tpu_torch.examples.optimality_gap\n"
        "import zfista_tpu_torch.examples.momentum_experiment\n"
        "import zfista_tpu_torch.parallel.sharding, zfista_tpu_torch.parallel.distributed\n"
        "import zfista_tpu_torch.bench.scaling, zfista_tpu_torch.examples.large_lasso\n"
        "import zfista_tpu_torch.examples.notebooks\n"
        "assert zfista_tpu_torch.native.load() is not None\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'zfista_tpu')\n"
        "             or m.startswith(('jax.', 'zfista_tpu.')))\n"
        "# The card's machine has no nbformat: the generator imports it late.\n"
        "bad += sorted(m for m in sys.modules if m in ('nbformat', 'nbclient'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_and_chip_smoke_are_staticcheck_clean():
    findings = staticcheck.run([ROOT / "zfista_tpu_torch", ROOT / "chip_smoke.py"])
    assert findings == []


def test_chip_smoke_refuses_to_run_without_cuda():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("setting", ["allow_tf32", "matmul_precision"])
def test_products_refuse_tf32(setting):
    a = torch.ones(3, 3)
    v = torch.ones(3)
    old_flag = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-fp32"):
            precision.matmul_hp(a, v)
        with pytest.raises(RuntimeError, match="full-fp32"):
            precision.dot_hp(v, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_flag
        torch.set_float32_matmul_precision(old_prec)
    assert float(precision.dot_hp(v, v)) == 3.0
    assert torch.equal(precision.matmul_hp(a, v), torch.full((3,), 3.0))


_STATE = solver.State(*(np.zeros(()) for _ in solver.State._fields))
_CARD_BY_DEFAULT = {
    "lasso_params_from_numpy": lambda **kw: interop.lasso_params_from_numpy(
        np.eye(2), np.ones(2), 0.1, **kw
    )[0],
    "state_from_numpy": lambda **kw: interop.state_from_numpy(_STATE, **kw).x,
    "tv_deblur_params_from_numpy": lambda **kw: interop.tv_deblur_params_from_numpy(
        np.ones((3, 3)), np.ones((3, 3)), 0.1, **kw
    )[0],
    "dual_from_numpy": lambda **kw: interop.dual_from_numpy(
        np.zeros((3, 3)), np.zeros((3, 3)), **kw
    )[0],
    "synthetic_cameraman": lambda **kw: deblur.synthetic_cameraman(8, **kw),
    "minimize_proximal_gradient_batch": lambda **kw: torch.as_tensor(
        minimize_proximal_gradient_batch(
            lambda x: x @ x, lambda x: 0 * x[0], None, lambda t, x: x, np.ones((2, 3)),
            max_iter=1, **kw,
        ).x
    ),
    "make_lasso_lambda_sweep": lambda **kw: lasso.make_lasso_lambda_sweep(
        np.eye(2), np.ones(2), **kw
    )[0](torch.zeros(2, dtype=torch.float64), 0.1),
    "make_group_lasso_lambda_sweep": lambda **kw: lasso.make_group_lasso_lambda_sweep(
        np.eye(2), np.ones(2), 2, **kw
    )[0](torch.zeros(2, dtype=torch.float64), 0.1),
    "distribute_global": lambda **kw: distributed.distribute_global(
        np.ones(2), make_mesh(), P("model"), **kw
    ),
}


@pytest.mark.parametrize("name", sorted(_CARD_BY_DEFAULT))
def test_data_entry_points_default_to_the_card(name, monkeypatch):
    """The functions that turn numpy data into the port's tensors put them
    on ``device="cuda"`` by default: with no card that raises (nothing
    falls back to the CPU), and ``device="cpu"`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _CARD_BY_DEFAULT[name]()
    out = _CARD_BY_DEFAULT[name](device="cpu")
    assert out.device.type == "cpu"
