"""``lane_iter_share`` (%): in a batch, the lanes' outer iterations over
the lane-iterations the batch ran, which its slowest lane sets:
``sum(nit) / (lanes * max(nit))`` summed over the calls.  Nothing to read
where a call holds one lane.
"""

from portbench import arith


def read(ctx):
    if all(c["nit"].size == 1 for c in ctx.calls):
        return None
    useful = sum(int(c["nit"].sum()) for c in ctx.calls)
    ran = sum(c["nit"].size * int(c["nit"].max()) for c in ctx.calls)
    return arith.share(useful, ran)
