"""Host ms a step inside the span ``msau.forward``: the model forward and
the masked CE enqueued, in the traced window."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, span="msau.forward")
