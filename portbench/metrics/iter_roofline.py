"""``iter_roofline`` (%): the least time a LASSO iteration can take, the
bytes of ``arith.lasso_iter_bytes`` (``A`` read once) over the card's
published bandwidth, over the wall per outer iteration of the calls
that ran after the profiler stopped (host clock, each call to its host
result; the traced calls run slower).  It reads the same
work whatever implements it.  Only configurations with an operator
(``m``, ``n``) have it.
"""

import numpy as np

from portbench import arith


def read(ctx):
    spec = ctx.spec
    if "m" not in spec or ctx.peaks is None:
        return None
    iters = sum(int(c["nit"].max()) for c in ctx.untraced)
    if not iters:
        return None
    least = arith.lasso_iter_bytes(spec["m"], spec["n"], np.dtype(spec["dtype"]).itemsize)
    least_s = least / ctx.peaks["hbm_bytes_per_s"]
    wall = sum(c["wall_s"] for c in ctx.untraced) / iters
    return arith.share(least_s, wall)
