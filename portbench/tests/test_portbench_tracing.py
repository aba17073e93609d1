"""The readers of the program's own tracing, on synthetic traces and
records: ``launch_idle_share`` counts idle time by its overlap with the
program's ``zt.graph.replay`` ranges; the counter readers read the
program's registry and nothing where it has none; the call-record readers
read the window's records only.  The card test captures a headline-sized
LASSO graph and reads its nodes and its replays' place on the profiler's
clock."""

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, trace

METRICS = harness.ROOT / "portbench" / "metrics"


def _reader(name):
    return harness.load_module(METRICS / f"{name}.py")


device_idle_share = _reader("device_idle_share")


class _Dev:
    def __init__(self, name):
        self.name = name


class _Event:
    """A profiler event as torch gives it, with its activity's name."""

    def __init__(self, kind, name, device, start, end, corr=0):
        self._kind, self._name, self._dev = kind, name, _Dev(device)
        self._s, self._e, self._corr = start, end, corr

    def activity_type(self):
        return self._kind

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._kind == "user_annotation"


def _trace(kernels, ranges, lo=0, hi=1000):
    """A traced window ``[lo, hi)`` ns: ``kernels`` on the device,
    ``ranges`` (name, start, end) of the program on the host."""
    events = [_Event("user_annotation", trace.WINDOW, "CPU", lo, hi)]
    events += [_Event("kernel", "k", "CUDA", s, e) for s, e in kernels]
    events += [_Event("user_annotation", n, "CPU", s, e) for n, s, e in ranges]
    return SimpleNamespace(trace=trace.Trace(events))


def test_an_idle_gap_half_inside_a_replay_counts_half():
    # Idle 400-600 ns; the replay covers 500-700: 100 ns of the 1000.
    ctx = _trace([(0, 400), (600, 1000)], [("zt.solve", 0, 1000), ("zt.graph.replay", 500, 700)])
    assert _reader("launch_idle_share").read(ctx) == pytest.approx(10.0)
    assert device_idle_share.read(ctx) == pytest.approx(20.0)


def test_no_replay_reads_zero_and_no_span_reads_nothing():
    kernels = [(0, 400), (600, 1000)]
    read = _reader("launch_idle_share").read
    assert read(_trace(kernels, [("zt.solve", 0, 1000), ("zt.drive", 100, 900)])) == 0.0
    assert read(_trace(kernels, [("portbench.call", 0, 1000)])) is None


def test_launch_idle_never_passes_device_idle():
    rng = np.random.default_rng(7)
    for _ in range(20):
        ks = np.sort(rng.integers(0, 100_000, 400)).reshape(-1, 2)
        rs = np.sort(rng.integers(0, 100_000, 60)).reshape(-1, 2)
        ctx = _trace([tuple(k) for k in ks], [("zt.graph.replay", *r) for r in rs], hi=100_000)
        launch = _reader("launch_idle_share").read(ctx)
        assert 0.0 <= launch <= device_idle_share.read(ctx)
    # Replays over the whole window: every idle gap counts, and no more.
    ctx = _trace([(100, 300), (500, 900)], [("zt.graph.replay", 0, 1000)])
    assert _reader("launch_idle_share").read(ctx) == pytest.approx(device_idle_share.read(ctx))


@pytest.fixture
def program(monkeypatch):
    """The program's tracing registry, emptied: counters and records the
    test sets."""
    from zfista_tpu_torch.utils import profiling

    counts = {}
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(counts))
    monkeypatch.setattr(profiling, "calls", deque())
    return SimpleNamespace(counts=counts, calls=profiling.calls, profiling=profiling)


def test_graph_nodes_per_step_needs_the_node_count(program):
    read = _reader("graph_nodes_per_step").read
    program.counts.update({"graph.captures": 4, "graph.steps": 256})
    assert read(None) is None  # captured on the CPU stand-in: no nodes
    program.counts["graph.nodes"] = 1280
    assert read(None) == 5.0


def test_setup_graph_s_sums_the_three_timers(program):
    read = _reader("setup_graph_s").read
    assert read(None) is None
    program.counts.update({"graph.first_chunk_ns": 2_000_000_000, "graph.record_ns": 500_000_000,
                           "graph.instantiate_ns": 250_000_000})
    assert read(None) == pytest.approx(2.75)


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    from zfista_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    monkeypatch.delattr(profiling, "calls")
    ctx = SimpleNamespace(calls=[{}] * 3)
    for name in ("graph_nodes_per_step", "setup_graph_s", "host_reads_per_call",
                 "entry_ms_per_call"):
        assert _reader(name).read(ctx) is None


def test_call_readers_take_the_window_records_only(program):
    warm_up = [{"host_reads": 99, "entry_self_ns": 9_000_000}] * 3
    window = [{"host_reads": 19, "entry_self_ns": 1_000_000},
              {"host_reads": 21, "entry_self_ns": 3_000_000}]
    program.calls.extend(warm_up + window)
    ctx = SimpleNamespace(calls=[{}, {}])
    assert _reader("host_reads_per_call").read(ctx) == 20.0
    assert _reader("entry_ms_per_call").read(ctx) == pytest.approx(2.0)
    # Fewer records than calls: a program that made none for some.
    assert _reader("host_reads_per_call").read(SimpleNamespace(calls=[{}] * 9)) is None


@pytest.mark.card
def test_a_headline_graph_counts_its_nodes_and_replays_on_the_shared_clock(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.models import Lasso

    gen = torch.Generator(device=card).manual_seed(0)
    m, n = 2000, 10_000
    A = torch.randn(m, n, generator=gen, device=card) / m**0.5
    b = A[:, :100] @ torch.randn(100, generator=gen, device=card)
    prob = Lasso(A, b, 0.01)
    x0 = torch.zeros(n, device=card)
    counts = solver.graph_counts
    nodes = []
    for _ in range(2):  # a capture, then the same key captured again
        solver._GRAPHS.clear()
        before = dict(counts)
        prob.solve_fixed_step(x0, tol=1e-5)
        assert counts["captures"] - before["captures"] == 1
        nodes.append(counts["nodes"] - before.get("nodes", 0))
    assert nodes[0] > 0 and nodes[0] == nodes[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prob.solve_fixed_step(x0, tol=1e-5)  # replays only
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    replays = [e for e in events if e.name() == "zt.graph.replay" and e.device_type().name == "CPU"]
    launches = [e for e in events if e.name() == "cudaGraphLaunch"]
    launched = {e.correlation_id() for e in launches}
    on_card = {}
    for e in events:
        if trace.device_work(e, launched):
            on_card.setdefault(e.correlation_id(), []).append(e.start_ns())
    assert replays and launches
    checked = 0
    for r in replays:
        for launch in launches:
            if r.start_ns() <= launch.start_ns() <= r.end_ns():
                starts = on_card.get(launch.correlation_id(), [])
                assert all(s >= r.start_ns() for s in starts)
                checked += len(starts)
    assert checked > 0
