"""``useful_step_share`` (%): the steps that moved a solve that had not yet
stopped, over the steps the replayed chunk graphs ran.

Steps run: the graph chunks the calls replayed or captured (the solver's
``graph_counts``) times the traffic's ``check_every``.  Moving steps: a
fixed step moves one iteration a step (``nit``); a carried line search
one trial a step, which a single-objective solve counts in
``nit_internal``.  At three or more objectives a step is one Newton
iteration, which the program does not count: nothing to read.
"""

from portbench import arith


def read(ctx):
    chunk = ctx.traffic["options"].get("check_every")
    if ctx.spec["objectives"] != 1 or not chunk:
        return None
    field = "nit" if ctx.traffic["options"].get("decay_rate") == 1 else "nit_internal"
    useful = sum(int(c[field].sum()) for c in ctx.calls)
    steps = sum(c["graph_chunks"] for c in ctx.calls) * int(chunk)
    return arith.share(useful, steps)
