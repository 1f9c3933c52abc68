"""Device ms a step of the flat scales' kernels (conv forward, dx and
weight gradient, concat 1x1 backward, residual block forward and backward,
deconv, pool, entry layout, weight-gradient partial sums)."""

from benchmark.trace import FLAT


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    fams = ctx.trace.families_s
    return 1e3 * sum(fams.get(f, 0.0) for f in FLAT) / ctx.units
