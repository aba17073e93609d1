"""``device_us_per_iter`` (us): the device's busy time over the traced
calls over the outer iterations they completed.  A batch's iterations are
its slowest lane's: ``max(nit)`` a call.
"""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_work:
        return None
    iters = sum(int(c["nit"].max()) for c in ctx.traced)
    return 1e6 * ctx.trace.busy_s / iters if iters else None
