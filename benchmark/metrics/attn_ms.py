"""Device ms a step of the attention's kernels, forward and backward."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 1e3 * ctx.trace.families_s.get("attention", 0.0) / ctx.units
