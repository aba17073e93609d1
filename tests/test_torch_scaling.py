"""The port's weak-scaling harness (``zfista_tpu_torch.bench.scaling``) on
the CPU: 1 and 2 spawned processes over Gloo at a small size give rows of
the JAX package's shape, a count above the devices raises as there, and
``format_table`` prints the JAX package's table byte for byte."""

from __future__ import annotations

import torch_env  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest

from zfista_tpu.bench import scaling as js
from zfista_tpu_torch.bench import scaling as ts

SMALL = dict(lanes_per_device=8, n_features=64, m_rows=16, n_iter=20, repeats=2)


@pytest.fixture(scope="module")
def rows():
    return ts.weak_scaling((2, 1), device="cpu", **SMALL)


def test_rows_have_the_jax_shape(rows):
    ref = js.weak_scaling((1, 2), **SMALL)
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    assert [(r["devices"], r["lanes"]) for r in rows] == [(r["devices"], r["lanes"]) for r in ref]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["seconds"] > 0 and np.isfinite(r["lane_iters_per_s"])
        assert r["per_device"] == pytest.approx(r["lane_iters_per_s"] / r["devices"])
        assert r["lane_iters_per_s"] == pytest.approx(r["lanes"] * SMALL["n_iter"] / r["seconds"])


def test_format_table_is_the_jax_table(rows):
    assert ts.format_table(rows) == js.format_table(rows)
    assert ts.format_table(rows).splitlines()[2].startswith("| 1 | 8 | ")


def test_more_devices_than_the_machine_raises(monkeypatch):
    monkeypatch.setattr(ts.os, "cpu_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        ts.weak_scaling((1, 3), device="cpu", **SMALL)
    with pytest.raises(ValueError, match="device"):
        ts.weak_scaling((1,), device="tpu", **SMALL)
