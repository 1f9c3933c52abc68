"""Host ms a step inside the span ``msau.update``: the gradient clip and
the optimizer update enqueued, in the traced window."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, span="msau.update")
