"""The plain references' parts against hand-worked and brute-force
cases, and one cell on the card (skipped without one)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import fds_n10, lasso_n10k


def test_round_tf32_keeps_ten_mantissa_bits():
    one = 1.0
    ulp = 2.0**-10  # TF32's spacing at 1
    v = torch.tensor([one, one + ulp, one + ulp / 2, one + 1.5 * ulp, one + ulp / 4, -3.0])
    got = lasso_n10k.round_tf32(v).tolist()
    # Ties go to even: 1 + ulp/2 -> 1, 1 + 1.5 ulp -> 1 + 2 ulp.
    assert got == [one, one + ulp, one, one + 2 * ulp, one, -3.0]


def test_simplex_qp_is_the_minimum_over_the_simplex():
    gen = torch.Generator().manual_seed(5)
    B, m = 64, 3
    J = torch.randn(B, m, 4, generator=gen, dtype=torch.float64)
    G = J @ J.transpose(1, 2)
    s = torch.randn(B, m, generator=gen, dtype=torch.float64)
    w = fds_n10.simplex_qp(G, s)
    assert torch.all(w >= 0) and torch.allclose(w.sum(1), torch.ones(B, dtype=torch.float64))
    value = lambda W: 0.5 * torch.einsum("bi,bij,bj->b", W, G, W) + (s * W).sum(1)  # noqa: E731
    # A grid over the simplex never beats the faces' best.
    k = 60
    grid = torch.tensor([(i / k, j / k, 1 - (i + j) / k) for i in range(k + 1)
                         for j in range(k + 1 - i)], dtype=torch.float64)
    best = torch.stack([value(g.expand(B, m)) for g in grid]).min(0).values
    assert torch.all(value(w) <= best + 1e-12)


def test_fds_objectives_and_jacobian_agree():
    x = torch.rand(5, 10, dtype=torch.float64) * 4 - 2
    J = fds_n10.jacobian(x)
    auto = torch.stack([torch.func.jacrev(lambda v: fds_n10.objectives(v[None])[0])(r) for r in x])
    assert torch.allclose(J, auto, rtol=1e-12, atol=1e-12)


@pytest.mark.card
def test_a_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lasso_n10k.fixed",
         "--seed", "2147483701", "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert np.isfinite(out["metrics"]["gemv_roofline"]["value"])
