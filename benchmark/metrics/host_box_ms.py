"""Host ms a step inside the span ``msau.box_conv``
(``models/msau_box.py``): the box convolutions' forward enqueued, in the
traced window."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, span="msau.box_conv")
