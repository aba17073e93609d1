"""``gemv_roofline`` (%): ``A``'s bytes read once a step over the card's
published bandwidth, over the device time of the matrix-vector kernels
(cuBLAS ``gemv``/``gemm`` by name in the trace of the traced calls)
a step.  A step is one
the chunk graphs ran (``graph_counts`` times ``check_every``): a fixed
step's two products, or a carried trial's four.
"""

import numpy as np

from portbench import arith

KERNELS = r"gemv|gemm"


def read(ctx):
    spec = ctx.spec
    chunk = ctx.traffic["options"].get("check_every")
    if ctx.trace is None or "m" not in spec or ctx.peaks is None or not chunk:
        return None
    steps = sum(c["graph_chunks"] for c in ctx.traced) * int(chunk)
    spent = ctx.trace.kernel_s(KERNELS)
    if not steps or not spent > 0:
        return None
    least = arith.lasso_operator_bytes(spec["m"], spec["n"], np.dtype(spec["dtype"]).itemsize)
    return arith.share(steps * least / ctx.peaks["hbm_bytes_per_s"], spent)
