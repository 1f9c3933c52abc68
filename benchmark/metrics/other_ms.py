"""Device ms a step of the masked CE's kernels and of every kernel of no
other family: the optimizer's, the loss's and the other torch ops."""

from benchmark.trace import OTHER


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    fams = ctx.trace.families_s
    return 1e3 * (fams.get("masked CE", 0.0) + fams.get(OTHER, 0.0)) / ctx.units
