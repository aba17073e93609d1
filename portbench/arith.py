"""The benchmark's arithmetic: tails, the device's busy union, byte counts.

Every number the benchmark reports that is not a raw reading comes from
here, so that a later change to the program cannot change how it is
counted.  Plain numpy; no torch.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def p95(values) -> float:
    """The 95th percentile of ``values`` (every call of the window), by
    linear interpolation between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def merged(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals ``[starts[i], ends[i])`` as sorted, disjoint
    intervals."""
    s = np.asarray(starts, np.float64)
    e = np.asarray(ends, np.float64)
    if s.size == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # A new interval starts where it begins past everything before it.
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], reach[last]


def busy(starts, ends, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi)`` covered by at least one interval."""
    s, e = merged(starts, ends)
    s, e = np.clip(s, lo, hi), np.clip(e, lo, hi)
    return float(np.sum(e - s))


def idle_gaps(starts, ends, lo: float, hi: float) -> tuple[np.ndarray, np.ndarray]:
    """The intervals of ``[lo, hi)`` that no interval covers."""
    s, e = merged(starts, ends)
    s, e = np.clip(s, lo, hi), np.clip(e, lo, hi)
    gap_s = np.concatenate([[lo], e])
    gap_e = np.concatenate([s, [hi]])
    keep = gap_e > gap_s
    return gap_s[keep], gap_e[keep]


def lasso_operator_bytes(m: int, n: int, itemsize: int) -> int:
    """``A``'s bytes, read once."""
    return m * n * itemsize


def lasso_iter_bytes(m: int, n: int, itemsize: int) -> int:
    """The least bytes one LASSO iteration moves: ``A`` read once, ``b``
    read, ``x`` and ``y`` read and written."""
    return itemsize * (m * n + m + 4 * n)


def share(part: float, whole: float) -> float | None:
    """``100 * part / whole`` in %, or None where ``whole`` is not positive."""
    if not whole > 0:
        return None
    return 100.0 * part / whole


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (the table in
    ``peaks.json``, matched by a key that the name contains), or None."""
    table = json.loads(PEAKS.read_text())
    for key, row in table.items():
        if key in kind:
            return row
    return None
