"""The traced run: torch.profiler over the traced calls, reduced to the
device's busy time, time by kernel name and idle gaps by host activity.

Kernel durations come from the profiler's device trace (CUPTI); its event
counts are not used, as they miss events on some runs.  The device's busy
time is the union of its kernel, copy and set intervals: the profiler's
own records and the ranges it mirrors on the device are not work
(:func:`device_work`).
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

from portbench import arith

#: Device activities that occupy the card, as the profiler names them.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: The profiler's own records on the device (CUPTI's overhead kinds),
#: which are no work of the program.
PROFILER_OVERHEAD = frozenset({
    "Unknown", "Driver Compiler", "Buffer Flush", "Instrumentation", "Resource",
    "Runtime Triggered Module Loading", "Lazy Function Loading", "Command Buffer Full",
    "Activity Buffer Request", "UVM Activity Init",
})
#: Host activities that can name what the host was doing in a gap.
HOST_WORK = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: Gaps labelled one by one, longest first; the rest are summed apart.
LABELLED_GAPS = 2000
TOP = 10


def start():
    """A started profiler of host and device activity (host only on a
    machine without a card, as the CPU tests run it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


#: The host range that marks the traced calls.
WINDOW = "portbench.traced"
#: The host calls that put work on the device: a device event is work
#: where its correlation id is one of theirs.
LAUNCHES = re.compile(r"^(cuda|cu)(LaunchKernel|GraphLaunch|Memcpy|Memset|LaunchCooperativeKernel)", re.I)


def _kind(ev) -> str | None:
    """The profiler's own name for an event's activity, where the
    installed torch gives one (older builds have no ``activity_type``)."""
    at = getattr(ev, "activity_type", None)
    return None if at is None else str(at())


def _annotation(ev) -> bool:
    check = getattr(ev, "is_user_annotation", None)
    return bool(check()) if check is not None else False


def device_work(ev, launched: set) -> bool:
    """Whether the device event ``ev`` is work: a kernel, a copy or a set.
    Where the profiler names the activity, by that name; else it is none
    of the profiler's own records or of the host's ranges mirrored on the
    device, and a host launch call traced in the window put it there
    (``launched``: those calls' correlation ids)."""
    if ev.device_type().name != "CUDA":
        return False
    kind = _kind(ev)
    if kind is not None:
        return kind in DEVICE_WORK
    if _annotation(ev) or ev.name() in PROFILER_OVERHEAD:
        return False
    return ev.correlation_id() in launched


def host_work(ev) -> bool:
    """Whether ``ev`` is a host activity that can name what the host was
    doing: an operator, a range, a runtime or driver call."""
    if ev.device_type().name != "CPU":
        return False
    kind = _kind(ev)
    return kind is None or kind in HOST_WORK


class Trace:
    """What the benchmark reads from one traced window: the span of the
    host range ``WINDOW`` on the profiler's clock."""

    def __init__(self, events) -> None:
        events = list(events)
        launched = {
            ev.correlation_id() for ev in events
            if ev.device_type().name == "CPU" and LAUNCHES.match(ev.name())
        }
        lo_ns = hi_ns = None
        dev_name, dev_s, dev_e = [], [], []
        host_name, host_s, host_e = [], [], []
        for ev in events:
            if device_work(ev, launched):
                dev_name.append(ev.name())
                dev_s.append(ev.start_ns())
                dev_e.append(ev.end_ns())
            elif host_work(ev):
                if ev.name() == WINDOW:
                    lo_ns, hi_ns = ev.start_ns(), ev.end_ns()
                    continue
                host_name.append(ev.name())
                host_s.append(ev.start_ns())
                host_e.append(ev.end_ns())
        if lo_ns is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        self.lo, self.hi = lo_ns * 1e-9, hi_ns * 1e-9
        self.dev_name = dev_name
        self.dev_s = np.asarray(dev_s, np.float64) * 1e-9
        self.dev_e = np.asarray(dev_e, np.float64) * 1e-9
        self.host_name = host_name
        self.host_s = np.asarray(host_s, np.float64) * 1e-9
        self.host_e = np.asarray(host_e, np.float64) * 1e-9

    @property
    def device_work(self) -> bool:
        """Whether any operation ran on the device in the window."""
        return bool(self.dev_s.size)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return arith.busy(self.dev_s, self.dev_e, self.lo, self.hi)

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``
        (a regular expression, case ignored)."""
        rx = re.compile(pattern, re.IGNORECASE)
        dur = self.dev_e - self.dev_s
        return float(sum(d for name, d in zip(self.dev_name, dur) if rx.search(name)))

    def device_ops(self) -> list[list]:
        """The operations that took most device time, by name."""
        total: dict[str, float] = defaultdict(float)
        for name, d in zip(self.dev_name, self.dev_e - self.dev_s):
            total[name] += float(d)
        return [[k[:200], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle device time summed by what the host was doing at each gap's
        midpoint (its innermost host activity), longest first; the gaps past
        the ``LABELLED_GAPS`` longest are summed as one entry."""
        gs, ge = arith.idle_gaps(self.dev_s, self.dev_e, self.lo, self.hi)
        if gs.size == 0:
            return []
        order = np.argsort(gs - ge)  # longest first
        labelled, rest = order[:LABELLED_GAPS], order[LABELLED_GAPS:]
        total: dict[str, float] = defaultdict(float)
        for i in labelled:
            mid = 0.5 * (gs[i] + ge[i])
            cover = np.flatnonzero((self.host_s <= mid) & (self.host_e > mid))
            label = "host: nothing traced"
            if cover.size:
                label = self.host_name[cover[np.argmax(self.host_s[cover])]]
            total[label] += float(ge[i] - gs[i])
        out = sorted(total.items(), key=lambda kv: -kv[1])
        if rest.size:
            out.append((f"{rest.size} shorter gaps", float(np.sum(ge[rest] - gs[rest]))))
        return [[k[:200], v] for k, v in out[:TOP]]


def stop(prof):
    """Stop ``prof``; its events are read later (:func:`read`)."""
    prof.stop()
    return prof


def read(prof) -> Trace:
    """The traced calls of the stopped profiler ``prof``."""
    return Trace(prof.profiler.kineto_results.events())
