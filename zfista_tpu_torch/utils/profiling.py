"""Profiling hooks: a ``torch.profiler`` trace and named scopes.

PyTorch-port counterpart of :mod:`zfista_tpu.utils.profiling`, where the
trace is the XLA profiler's.  Usage::

    from zfista_tpu_torch.utils.profiling import annotate, trace
    with trace("profile"):               # a Chrome trace (chrome://tracing,
        with annotate("zt.lasso"):       # Perfetto) of the CPU and the card
            prob.solve_fixed_step(x0)
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ["annotate", "trace"]


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


class _Annotation:
    """Named profiler scope usable as a context manager OR a decorator:
    a ``torch.profiler.record_function`` range, plus an NVTX range when
    CUDA is initialised."""

    def __init__(self, name: str) -> None:
        self._name = name
        # Stack, not a single slot: one annotation object may be entered
        # reentrantly (nested `with ann:` blocks); a lone slot would be
        # clobbered by the inner entry and __exit__ would then close the
        # wrong scope.  (Scopes are per-thread LIFO: don't share one
        # annotation object across threads.)
        self._stack: list[tuple[torch.profiler.record_function, bool]] = []

    def __enter__(self):
        nvtx = torch.cuda.is_initialized()
        if nvtx:
            torch.cuda.nvtx.range_push(self._name)
        ctx = torch.profiler.record_function(self._name)
        self._stack.append((ctx, nvtx))
        return ctx.__enter__()

    def __exit__(self, *exc):
        ctx, nvtx = self._stack.pop()
        try:
            return ctx.__exit__(*exc)
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Annotation(self._name):
                return fn(*args, **kwargs)

        return wrapped


def annotate(name: str) -> _Annotation:
    """Named-scope annotation for profiler timelines (decorator or ctx)."""
    return _Annotation(name)
