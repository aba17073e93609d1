"""The benchmark's arithmetic against hand-worked cases."""

import numpy as np
import pytest

from portbench import arith


def test_p95_interpolates_between_order_statistics():
    # 20 values 1..20: rank 0.95 * 19 = 18.05, between 19 and 20.
    assert arith.p95(range(1, 21)) == pytest.approx(19.05)
    assert arith.p95([7.0]) == 7.0
    # Every call counts, the order does not.
    assert arith.p95([5, 1, 4, 2, 3]) == pytest.approx(4.8)


def test_busy_union_counts_overlaps_once():
    starts, ends = [0.0, 1.0, 1.5, 5.0], [2.0, 1.2, 3.0, 6.0]
    s, e = arith.merged(starts, ends)
    assert s.tolist() == [0.0, 5.0] and e.tolist() == [3.0, 6.0]
    assert arith.busy(starts, ends, 0.0, 10.0) == pytest.approx(4.0)
    # Clipped to the window.
    assert arith.busy(starts, ends, 1.0, 5.5) == pytest.approx(2.5)
    assert arith.busy([], [], 0.0, 1.0) == 0.0


def test_idle_gaps_are_the_complement():
    gs, ge = arith.idle_gaps([1.0, 4.0], [2.0, 5.0], 0.0, 6.0)
    assert gs.tolist() == [0.0, 2.0, 5.0] and ge.tolist() == [1.0, 4.0, 6.0]
    gs, ge = arith.idle_gaps([0.0], [6.0], 0.0, 6.0)
    assert gs.size == 0


def test_lasso_bytes_count_the_operator_once():
    # 2000 x 10000 float32: 80 MB; an iteration adds b and x, y in and out.
    assert arith.lasso_operator_bytes(2000, 10000, 4) == 80_000_000
    assert arith.lasso_iter_bytes(2000, 10000, 4) == 4 * (20_000_000 + 2000 + 40_000)


def test_share_and_peaks():
    assert arith.share(1, 4) == 25.0
    assert arith.share(1, 0) is None
    assert arith.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert arith.peaks("cpu") is None


def test_metric_readers_on_hand_worked_calls():
    from types import SimpleNamespace

    from portbench.harness import load_module, HERE

    read = lambda name, ctx: load_module(HERE / "metrics" / f"{name}.py").read(ctx)  # noqa: E731
    calls = [
        {"nit": np.array([300]), "nit_internal": np.array([304]), "graph_chunks": 5, "wall_s": 0.024},
        {"nit": np.array([290]), "nit_internal": np.array([294]), "graph_chunks": 5, "wall_s": 0.023},
    ]
    spec = {"objectives": 1, "m": 2000, "n": 10000, "dtype": "float32"}
    fixed = {"options": {"check_every": 64, "decay_rate": 1}}
    ctx = SimpleNamespace(spec=spec, traffic=fixed, calls=calls, trace=None,
                          peaks=arith.peaks("H100"), traced=calls[:1], untraced=calls[1:])
    assert read("useful_step_share", ctx) == pytest.approx(100 * 590 / 640)
    ctx.traffic = {"options": {"check_every": 64, "decay_rate": 0.5}}
    assert read("useful_step_share", ctx) == pytest.approx(100 * 598 / 640)
    # 80,082,000 bytes at 3.35 TB/s over the untraced call's 23 ms / 290
    # iterations.
    least = 4 * (20_000_000 + 2000 + 40_000) / 3.35e12
    assert read("iter_roofline", ctx) == pytest.approx(100 * least / (0.023 / 290))
    assert read("lane_iter_share", ctx) is None  # one lane a call
    assert read("newton_per_iter", ctx) is None  # one objective
    assert read("device_idle_share", ctx) is None  # no trace
    trace = SimpleNamespace(busy_s=0.04, window_s=0.05, device_work=True,
                            kernel_s=lambda pattern: 0.032)
    ctx.trace = trace
    assert read("device_idle_share", ctx) == pytest.approx(20.0)
    # Over the traced call alone: 300 iterations in 5 chunks of 64 steps.
    assert read("device_us_per_iter", ctx) == pytest.approx(1e6 * 0.04 / 300)
    # A read once a step: 320 steps * 80 MB / 3.35 TB/s over 32 ms of GEMVs.
    assert read("gemv_roofline", ctx) == pytest.approx(100 * 320 * 8e7 / 3.35e12 / 0.032)
    ctx.untraced = []
    assert read("iter_roofline", ctx) is None  # no call ran untraced
    batch = [{"nit": np.array([10, 20, 40]), "nit_internal": np.array([100, 200, 400])}]
    ctx = SimpleNamespace(spec={"objectives": 3}, traffic={"options": {"check_every": 8}},
                          calls=batch, trace=None, peaks=None, traced=batch, untraced=[])
    assert read("lane_iter_share", ctx) == pytest.approx(100 * 70 / 120)
    assert read("newton_per_iter", ctx) == pytest.approx(10.0)
    assert read("useful_step_share", ctx) is None
