"""The port's multi-process runtime: real OS processes, one rank each, over
Gloo on the CPU (``python -m zfista_tpu_torch.parallel.distributed``, as
``tests/test_distributed.py`` runs the JAX package's worker).

Every rank solves a λ-sweep batch and an m=3 momentum-pair batch with the
lanes sharded over all ranks (bitwise their unsharded torch twin on the
rank), a LASSO with its features sharded over all ranks (equal ``nit``,
x within 1e-9 of the unsharded torch solve) and, on the ``(n/2, 2)``
``("batch", "model")`` mesh, the vmapped dense step, a λ sweep and
``Lasso.solve_batch`` (equal ``nit``, x within 1e-10), and prints
``PARITY_OK``, ``TP_PARITY_OK`` and ``MESH2D_PARITY_OK``.  Rank 0 writes the feature-sharded solve, which this test
holds against the JAX package's unsharded solve on the same data (JAX x64:
equal ``nit``, x within 1e-10).
"""

from __future__ import annotations

from torch_env import RANKS_TIMEOUT, child_env, run_world
import sys
from pathlib import Path

import numpy as np
import pytest

from zfista_tpu.models.lasso import Lasso

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n_processes", [2, 4])
def test_sharded_solves_match_unsharded(n_processes, tmp_path):
    out = tmp_path / "tp.npz"
    procs = run_world(
        lambda i, port: [sys.executable, "-m", "zfista_tpu_torch.parallel.distributed",
                         "--coordinator", f"localhost:{port}", "--num-processes", str(n_processes),
                         "--process-id", str(i), "--platform", "cpu", "--backend", "gloo",
                         "--out", str(out)],
        n_processes, cwd=REPO, timeout=RANKS_TIMEOUT, env=child_env(PYTHONPATH=str(REPO)),
    )
    for i, (code, text) in enumerate(procs):
        assert code == 0, f"process {i} failed:\n{text[-3000:]}"
        assert f"PARITY_OK process={i}/{n_processes}" in text, text[-2000:]
        assert f"TP_PARITY_OK process={i}/{n_processes}" in text, text[-2000:]
        assert f"MESH2D_PARITY_OK process={i}/{n_processes}" in text, text[-2000:]

    r = np.load(out)
    ref = Lasso(r["A"], r["b"], l1_ratio=0.05).solve_fixed_step(
        np.zeros(r["A"].shape[1]), lr=float(r["lr"]), max_iter=20000
    )
    assert ref.success and int(r["nit"]) == ref.nit
    np.testing.assert_allclose(r["x"], ref.x, rtol=0, atol=1e-10)
