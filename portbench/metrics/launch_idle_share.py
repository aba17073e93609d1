"""``launch_idle_share`` (%): the device's idle time inside the program's
graph launches over the traced window: the parts of the idle gaps
(``arith.idle_gaps``) that ``zt.graph.replay`` host ranges cover, counted
by overlap, so it never passes ``device_idle_share``.  0 where the program
traced its spans and replayed no graph; nothing to read from a trace with
no ``zt.`` span (a program without them).
"""

import numpy as np

from portbench import arith

SPAN = "zt.graph.replay"


def covered(starts, ends, at):
    """The length of ``[-inf, t)`` that the intervals cover, at each ``t``
    of ``at``."""
    s, e = arith.merged(starts, ends)
    at = np.asarray(at, np.float64)
    if s.size == 0:
        return np.zeros_like(at)
    before = np.concatenate([[0.0], np.cumsum(e - s)])
    i = np.searchsorted(s, at, side="right")  # intervals that start by t
    over = np.where(i > 0, np.maximum(e[np.maximum(i - 1, 0)] - at, 0.0), 0.0)
    return before[i] - over


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_work or not any(n.startswith("zt.") for n in t.host_name):
        return None
    replay = np.array([n == SPAN for n in t.host_name], bool)
    gs, ge = arith.idle_gaps(t.dev_s, t.dev_e, t.lo, t.hi)
    rs = np.clip(t.host_s[replay], t.lo, t.hi)
    re_ = np.clip(t.host_e[replay], t.lo, t.hi)
    inside = float(np.sum(covered(rs, re_, ge) - covered(rs, re_, gs)))
    return arith.share(inside, t.window_s)
