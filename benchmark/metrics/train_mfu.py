"""The training step's share of the card's f32 peak: the benchmark's own
operations of a step (forward and backward, from shapes:
``counts.msau_flops``) over the traced window's time a step and over
``counts.PEAK_F32_FLOPS``, in %."""

from benchmark import counts


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or "flops" not in ctx.work:
        return None
    step_s = ctx.window_s / ctx.units
    return 100.0 * ctx.work["flops"]["train"] / step_s / counts.PEAK_F32_FLOPS
