"""``newton_per_iter`` (inner/iter): the solver's inner count over its
outer iterations, ``sum(nit_internal) / sum(nit)`` over every solve of the
window.  At three or more objectives the inner count is the m >= 3 Newton
solver's (its dual evaluations: ``m + 1`` and the arc trials an
iteration); other configurations have nothing to read.
"""


def read(ctx):
    if ctx.spec["objectives"] < 3:
        return None
    nit = sum(int(c["nit"].sum()) for c in ctx.calls)
    inner = sum(int(c["nit_internal"].sum()) for c in ctx.calls)
    return inner / nit if nit else None
