"""What the per-layer readers read from the program itself, after the
window, in the process that ran it: its tracing registry's counters and
call records (``zfista_tpu_torch.utils.profiling``).  A program without
them gives nothing to read: an empty dict or None, never an error.
"""

from __future__ import annotations


def _profiling():
    from zfista_tpu_torch.utils import profiling

    return profiling


def counters() -> dict[str, int]:
    """The program's counters now, ``{"group.key": value}``; empty where it
    has no registry."""
    snapshot = getattr(_profiling(), "snapshot", None)
    return snapshot() if snapshot is not None else {}


def window_records(ctx) -> list[dict] | None:
    """The program's call records of the window: the last ``len(ctx.calls)``
    records, one for each call, as nothing calls the program between the
    window's end and the readers.  None where there are fewer (or none)."""
    records = list(getattr(_profiling(), "calls", ()))
    n = len(ctx.calls)
    return records[-n:] if n and len(records) >= n else None
