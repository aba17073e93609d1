"""Tracing: named spans on the profiler's timeline, counters, call records.

PyTorch-port counterpart of :mod:`zfista_tpu.utils.profiling`, where the
trace is the XLA profiler's.  One layer in three parts:

* **Spans** (:func:`annotate`, a context manager or a decorator), at the
  port's layer boundaries: ``zt.solve`` and ``zt.solve_batch`` (a facade,
  whole), ``zt.setup``, ``zt.pack`` and ``zt.lipschitz`` (its set-up, its
  result and a model's power iteration), ``zt.drive`` (a chunk loop),
  ``zt.host_read`` (a driver's read of its stop flag), and
  ``zt.graph.first_chunk``, ``zt.graph.record``, ``zt.graph.instantiate``
  and ``zt.graph.replay`` (a chunk graph's capture and launch).  While a
  ``torch.profiler`` records, a span is a ``record_function`` range on
  the profiler's clock, beside the device's kernels, and :func:`trace`'s
  Chrome trace carries it; otherwise a span costs one check of the
  profiler's state.
* **Counters** (:data:`COUNTERS`), always on: plain integer adds on the
  host, never inside a graph.  Each module registers its own dict
  (:func:`register`); :func:`snapshot` copies them all.
* **Call records** (:data:`calls`), always on: one for each outermost
  call of a facade.

Usage::

    from zfista_tpu_torch.utils.profiling import trace
    with trace("profile"):               # a Chrome trace (chrome://tracing,
        prob.solve_fixed_step(x0)        # Perfetto) with the zt.* spans
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any

import torch

__all__ = [
    "COUNTERS",
    "annotate",
    "calls",
    "cuda_graph_nodes",
    "device_to_host",
    "read_flag",
    "register",
    "snapshot",
    "trace",
]


@contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    plus CUDA when a card is present) and write its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


# -- counters ----------------------------------------------------------------

#: Every counter group of the port, ``{group: {key: value}}``: the dicts
#: the modules count in, registered as the same objects.
COUNTERS: dict[str, dict[str, int]] = {}


def register(group: str, counts: dict[str, int]) -> dict[str, int]:
    """Register the dict ``counts`` as the counter group ``group``; returns
    it."""
    COUNTERS[group] = counts
    return counts


def snapshot() -> dict[str, int]:
    """Every counter now, flat: ``{"group.key": value}``."""
    return {f"{g}.{k}": v for g, counts in COUNTERS.items() for k, v in counts.items()}


#: Device-to-host reads made by the drivers and the facades
#: (:func:`device_to_host`).
host_counts = register("host", {"reads": 0})


def device_to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host, counted in ``host.reads``: every read of
    the device that a driver or a facade makes goes through here."""
    host_counts["reads"] += 1
    return t.detach().cpu()


def read_flag(t: torch.Tensor) -> bool:
    """``bool(t)`` of the device flag ``t``, counted in ``host.reads`` as
    :func:`device_to_host` counts, in a ``zt.host_read`` span: a driver's
    decision whether to go on."""
    with _Annotation("zt.host_read"):
        host_counts["reads"] += 1
        return bool(t)


# -- call records ------------------------------------------------------------

#: Call records kept, the oldest dropped first.
CALLS_KEPT = 65_536
#: One record for each outermost call of a facade (a span entered with
#: ``call="entry"``), newest last: ``call`` (the id its spans carry),
#: ``wall_ns``, ``entry_self_ns`` (the wall less the time inside its
#: outermost ``zt.drive`` spans), and the ``host_reads`` and graph
#: ``replays`` made during it.
calls: deque[dict[str, int]] = deque(maxlen=CALLS_KEPT)

_ids = itertools.count(1)
# The thread's open call: its record (None outside a call) and how deep
# its drive spans are nested.
_open = threading.local()


def _current() -> dict | None:
    return getattr(_open, "record", None)


def _replays() -> int:
    return COUNTERS.get("graph", {}).get("replays", 0)


def _begin_call() -> dict | None:
    """Open a call record, or None inside one: a nested entry (a model's
    method calling a facade) makes no record of its own."""
    if _current() is not None:
        return None
    rec = {"call": next(_ids), "t0": time.perf_counter_ns(), "drive_ns": 0,
           "reads": host_counts["reads"], "replays": _replays()}
    _open.record, _open.depth = rec, 0
    return rec


def _end_call(rec: dict | None) -> None:
    if rec is None:
        return
    wall = time.perf_counter_ns() - rec["t0"]
    _open.record = None
    calls.append({
        "call": rec["call"],
        "wall_ns": wall,
        "entry_self_ns": wall - rec["drive_ns"],
        "host_reads": host_counts["reads"] - rec["reads"],
        "replays": _replays() - rec["replays"],
    })


def _begin_drive() -> tuple[dict, int | None] | None:
    """Enter a drive span of the open call (None outside a call); only the
    outermost one of a nest is timed."""
    rec = _current()
    if rec is None:
        return None
    _open.depth += 1
    return rec, time.perf_counter_ns() if _open.depth == 1 else None


def _end_drive(mark: tuple[dict, int | None] | None) -> None:
    if mark is None:
        return
    rec, t0 = mark
    _open.depth -= 1
    if t0 is not None:
        rec["drive_ns"] += time.perf_counter_ns() - t0


# -- spans -------------------------------------------------------------------

_ROLES = {
    None: (None, None),
    "entry": (_begin_call, _end_call),
    "drive": (_begin_drive, _end_drive),
}


class _Annotation:
    """A named span, usable as a context manager or a decorator (see
    :func:`annotate`)."""

    def __init__(self, name: str, call: str | None = None) -> None:
        if call not in _ROLES:
            raise ValueError(f"call must be None, 'entry' or 'drive'; got {call!r}")
        self._name = name
        self._call = call
        self._begin, self._end = _ROLES[call]
        # Stack, not a single slot: one annotation object may be entered
        # reentrantly (nested `with ann:` blocks); a lone slot would be
        # clobbered by the inner entry and __exit__ would then close the
        # wrong scope.  (Scopes are per-thread LIFO: don't share one
        # annotation object across threads.)
        self._stack: list[tuple[Any, Any]] = []

    def __enter__(self) -> _Annotation:
        mark = self._begin() if self._begin is not None else None
        span = None
        if torch.autograd._profiler_enabled():
            rec = _current()
            span = torch.profiler.record_function(
                self._name, None if rec is None else str(rec["call"])
            )
            span.__enter__()
        self._stack.append((span, mark))
        return self

    def __exit__(self, *exc) -> bool:
        span, mark = self._stack.pop()
        try:
            if span is not None:
                span.__exit__(*exc)
        finally:
            if self._end is not None:
                self._end(mark)
        return False

    def __call__(self, fn):
        name, call = self._name, self._call

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Annotation(name, call):
                return fn(*args, **kwargs)

        return wrapped


def annotate(name: str, call: str | None = None) -> _Annotation:
    """A named span (a context manager or a decorator).

    While a ``torch.profiler`` records (:func:`trace`, or any profiler),
    the span is a ``torch.profiler.record_function`` range with the open
    call's id as its ``args``; otherwise the span costs one check of
    ``torch.autograd._profiler_enabled()``.  The profiler keeps the range
    in memory until its trace is written; there is no exporter of its own.
    (torch's profiler keeps the range but not a string ``args`` in its
    events: a call's ranges are those inside its outermost ``zt.solve`` or
    ``zt.solve_batch`` range.)  Nothing is pushed to NVTX: nothing in the
    project reads NVTX ranges, and the push cost every span with the
    profiler off.

    ``call`` gives the span a role in the call records (:data:`calls`),
    which are kept whether a profiler records or not: ``"entry"`` (a
    facade: the outermost one makes the call's record), ``"drive"`` (a
    chunk loop: its time is what the record's ``entry_self_ns`` leaves
    out), or None."""
    return _Annotation(name, call)


# -- CUDA graph nodes --------------------------------------------------------


def cuda_graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of the recorded ``graph`` (kept: ``keep_graph=True``), by
    the CUDA runtime's ``cudaGraphGetNodes`` on ``raw_cuda_graph()``."""
    count = ctypes.c_size_t(0)
    status = _graph_get_nodes()(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count)
    )
    if status != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed with status {status}")
    return int(count.value)


@functools.cache
def _graph_get_nodes():
    """``cudaGraphGetNodes`` of the CUDA runtime torch loaded (found by its
    name among the libraries the process holds), else the driver's
    ``cuGraphGetNodes``: one graph handle serves both."""
    major = (torch.version.cuda or "12").split(".")[0]
    try:
        fn = ctypes.CDLL(f"libcudart.so.{major}", mode=os.RTLD_NOLOAD).cudaGraphGetNodes
    except OSError:
        fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn
