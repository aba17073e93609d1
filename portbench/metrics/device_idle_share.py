"""``device_idle_share`` (%): the share of the traced window in which no
kernel, copy or set ran on the device."""

from portbench import arith


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_work:
        return None
    return arith.share(ctx.trace.window_s - ctx.trace.busy_s, ctx.trace.window_s)
