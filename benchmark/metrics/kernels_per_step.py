"""Kernel launches on the card a step, from the profiler's records."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.units
