"""Host ms a step inside the span ``msau.backward``
(``torch.autograd.grad``): the host waits while autograd's device thread
enqueues every backward kernel, in the traced window."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, span="msau.backward")
