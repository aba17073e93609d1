"""The port's tracing layer (``zfista_tpu_torch.utils.profiling``) on the CPU.

* with no profiler recording, no span enters ``record_function``, and a
  solve's result is bitwise the one it gives under a recording profiler;
* under a CPU ``torch.profiler`` the ``zt.*`` ranges nest as the layers do
  (the facade's set-up, chunk loop and packing inside its ``zt.solve`` or
  ``zt.solve_batch``, the flag reads inside the loop, the graph's capture
  and replays inside the loop), and every range of one call carries the
  call's id;
* ``host.reads`` of a CPU solve is the count read from the code: the
  start's copy, one flag read a chunk and one more, and the result's
  twelve fields;
* one call record a call, a model's method over the facade included;
* the graphed path (through a stand-in for the CUDA graph, as in
  tests/test_torch_graph.py) counts the capture, the replays, the steps
  and the capture's three host timers, and no graph nodes.
"""

import torch_env  # noqa: F401  (one torch thread a process)

import numpy as np
import pytest
import torch

from zfista_tpu_torch.core import solver
from zfista_tpu_torch.models import FDS, JOS1, Lasso
from zfista_tpu_torch.utils import profiling
from zfista_tpu_torch.utils.profiling import annotate

STATE_FIELDS = len(solver.State._fields)


def _lasso(seed=3, m=40, n=120, k=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    lr = 1.0 / (2 * np.linalg.norm(A, 2) ** 2)
    return Lasso(torch.tensor(A), torch.tensor(b), 0.05), lr


def _solves():
    """Solves over each facade and driver the CPU runs: the fixed step
    chunked, the backtracking search, an m >= 3 single solve, a batch and
    a batch with history."""
    prob, lr = _lasso()
    x0 = np.zeros(prob.n_features)
    x0s = torch.tensor(np.random.default_rng(5).uniform(-2, 2, (4, 5)))
    return {
        "fixed": lambda: prob.solve_fixed_step(x0, lr=lr, tol=1e-6, check_every=8),
        "backtrack": lambda: prob.solve(x0, lr=1.0, nesterov=True, tol=1e-6, max_iter=200),
        "m3": lambda: FDS(n_features=4).solve(torch.full((4,), 0.5, dtype=torch.float64),
                                             nesterov=True, max_iter=30),
        "batch": lambda: JOS1().solve_batch(x0s, nesterov=True, check_every=4),
        "history": lambda: JOS1().solve_batch(x0s, nesterov=True, history=True),
    }


def _fields(res):
    return [np.asarray(v) for v in res.state]


def _same(a, b):
    return all(u.dtype == v.dtype and np.array_equal(u, v, equal_nan=True) for u, v in zip(a, b))


def _recording(monkeypatch):
    """``torch.profiler.record_function`` wrapped: every range a span
    enters, as ``(name, args)``."""
    entered = []
    real = torch.profiler.record_function

    def record(name, args=None):
        entered.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    return entered


@pytest.mark.parametrize("kind", ["fixed", "backtrack", "m3", "batch", "history"])
def test_spans_off_enter_nothing_and_change_no_bit(kind, monkeypatch):
    solve = _solves()[kind]
    entered = _recording(monkeypatch)
    off = solve()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = solve()
    assert entered and all(name.startswith("zt.") for name, _ in entered)
    assert _same(_fields(off), _fields(on))
    assert np.array_equal(np.asarray(off.nit), np.asarray(on.nit))


def _ranges(prof):
    """The ``zt.*`` ranges of ``prof`` with their ancestors' names."""
    out = []
    for ev in prof.events():
        if ev.name.startswith("zt."):
            up, chain = ev.cpu_parent, []
            while up is not None:
                chain.append(up.name)
                up = up.cpu_parent
            out.append((ev.name, chain))
    return out


#: Each span and the span it lies inside.
NESTING = {
    "zt.setup": "zt.solve",
    "zt.drive": "zt.solve",
    "zt.pack": "zt.solve",
    "zt.host_read": "zt.drive",
    "zt.lipschitz": "zt.solve",
}


def test_spans_nest_as_the_layers_and_carry_the_call(monkeypatch):
    prob, _ = _lasso()
    x0 = np.zeros(prob.n_features)
    entered = _recording(monkeypatch)
    before = len(profiling.calls)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prob.solve_fixed_step(x0, tol=1e-6, check_every=8)  # 1/L: the power iteration
        JOS1().solve_batch(torch.zeros((4, 5), dtype=torch.float64), nesterov=True)
    ranges = _ranges(prof)
    names = {name for name, _ in ranges}
    assert {"zt.solve", "zt.solve_batch", "zt.setup", "zt.drive", "zt.pack", "zt.host_read",
            "zt.lipschitz"} <= names
    for name, chain in ranges:
        if name in NESTING:
            entry = "zt.solve_batch" if "zt.solve_batch" in chain else "zt.solve"
            assert NESTING[name].replace("zt.solve", entry) in chain, (name, chain)
    # The model's zt.solve holds the facade's: one call, one id.
    solve_chains = [chain for name, chain in ranges if name == "zt.solve"]
    assert sorted(c.count("zt.solve") for c in solve_chains) == [0, 1]
    records = list(profiling.calls)[before:]
    assert len(records) == 2
    ids = [str(r["call"]) for r in records]
    # Ranges are entered in call order: the first call's, then the second's.
    args = [a for _, a in entered]
    split = args.index(ids[1])
    assert set(args[:split]) == {ids[0]} and set(args[split:]) == {ids[1]}


@pytest.mark.parametrize("check_every", [1, 8, 64])
def test_host_reads_of_a_cpu_solve_are_the_code_count(check_every):
    prob, lr = _lasso()
    before = profiling.snapshot()["host.reads"]
    res = prob.solve_fixed_step(np.zeros(prob.n_features), lr=lr, tol=1e-6,
                                check_every=check_every)
    chunks = -(-res.nit // check_every)
    # x0's copy, a flag read before each chunk and after the last, and the
    # result's fields (lr given: no power iteration).
    want = 1 + (chunks + 1) + STATE_FIELDS
    assert profiling.snapshot()["host.reads"] - before == want
    assert profiling.calls[-1]["host_reads"] == want
    assert profiling.calls[-1]["replays"] == 0


def test_a_batch_counts_its_reads_as_the_code_does():
    x0s = torch.zeros((4, 5), dtype=torch.float64)
    res = JOS1().solve_batch(x0s, nesterov=True, check_every=4)
    chunks = -(-int(np.max(res.nit)) // 4)
    assert profiling.calls[-1]["host_reads"] == 1 + (chunks + 1) + STATE_FIELDS


@pytest.mark.parametrize("kind", ["model over the facade", "facade", "batch"])
def test_one_call_record_a_call(kind):
    prob, lr = _lasso()
    x0 = np.zeros(prob.n_features)
    run = {
        "model over the facade": lambda: prob.solve_fixed_step(x0, tol=1e-6, check_every=8),
        "facade": lambda: solver.minimize_proximal_gradient(
            prob.f, prob.g, prob.jac_f, prob.prox_wsum_g, torch.zeros(prob.n_features,
                                                                       dtype=torch.float64),
            lr=lr, decay_rate=1, nesterov=True, tol=1e-6),
        "batch": lambda: JOS1().solve_batch(torch.zeros((4, 5), dtype=torch.float64)),
    }[kind]
    before = len(profiling.calls)
    last = profiling.calls[-1]["call"] if profiling.calls else 0
    run()
    assert len(profiling.calls) == before + 1
    rec = profiling.calls[-1]
    assert rec["call"] > last
    assert 0 <= rec["entry_self_ns"] <= rec["wall_ns"]
    assert rec["host_reads"] > STATE_FIELDS


def test_drive_time_is_left_out_of_the_entry_once():
    with annotate("zt.solve", call="entry"):
        with annotate("zt.solve", call="entry"):  # nested: no record of its own
            with annotate("zt.drive", call="drive"):
                with annotate("zt.drive", call="drive"):  # nested: timed once
                    torch.ones(4000).cumsum(0)
    rec = profiling.calls[-1]
    assert 0 < rec["entry_self_ns"] < rec["wall_ns"]
    with pytest.raises(ValueError, match="call must be"):
        annotate("zt.solve", call="outer")


class _Replay:
    """The CUDA graph's stand-in (tests/test_torch_graph.py's): its
    "capture" runs the chunk and restores the static buffers; a replay
    runs the chunk."""

    def __init__(self, chunk, static, stream):
        self.chunk, self.static = chunk, static
        saved = [v.clone() for v in static]
        chunk(static)
        for s, v in zip(static, saved):
            s.copy_(v)

    def replay(self):
        self.chunk(self.static)


def test_the_graphed_path_counts_captures_replays_and_timers(monkeypatch):
    monkeypatch.setattr(solver, "CHUNK_GRAPH", _Replay)
    monkeypatch.setattr(solver, "_graphs_run_on", lambda device: True)
    monkeypatch.setattr(solver, "_GRAPHS", solver.OrderedDict())
    prob, lr = _lasso()
    x0 = np.zeros(prob.n_features)
    entered = []
    before = profiling.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # a capture, then replays only
            res = prob.solve_fixed_step(x0, lr=lr, tol=1e-6, check_every=8)
            entered.append(profiling.calls[-1])
    after = profiling.snapshot()
    grew = {k: after[k] - before[k] for k in before}
    chunks = -(-res.nit // 8)
    assert grew["graph.captures"] == 1 and grew["graph.steps"] == 8
    assert grew["graph.replays"] == 2 * chunks - 1
    assert [r["replays"] for r in entered] == [chunks - 1, chunks]
    assert grew["graph.first_chunk_ns"] > 0 and grew["graph.record_ns"] > 0
    assert grew["graph.instantiate_ns"] >= 0
    assert "graph.nodes" not in after
    ranges = _ranges(prof)
    for name in ("zt.graph.first_chunk", "zt.graph.record", "zt.graph.instantiate"):
        (chain,) = [c for n, c in ranges if n == name]
        assert "zt.drive" in chain
    replays = [c for n, c in ranges if n == "zt.graph.replay"]
    assert len(replays) == 2 * chunks - 1 and all("zt.drive" in c for c in replays)


def test_snapshot_reads_the_registered_dicts():
    from zfista_tpu_torch.ops import fused, tv_cuda
    from zfista_tpu_torch.parallel import sharding

    snap = profiling.snapshot()
    assert profiling.COUNTERS["graph"] is solver.graph_counts
    assert profiling.COUNTERS["fused"] is fused.launch_counts
    assert profiling.COUNTERS["tv_cuda"] is tv_cuda.launch_counts
    assert profiling.COUNTERS["collectives"] is sharding.collective_counts
    assert snap["fused.lasso_step_tail"] == fused.launch_counts["lasso_step_tail"]
    assert snap["graph.replays"] == solver.graph_counts["replays"]
    assert snap["host.reads"] == profiling.COUNTERS["host"]["reads"]
