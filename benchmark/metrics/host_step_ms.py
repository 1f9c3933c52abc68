"""Host ms a step inside the span ``msau.train_step``
(``train/trainer.py:make_train_step``): the host's enqueue of the forward,
backward and update, from the step's call to its return, in the traced
window (the profiler's per-op recording included)."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, span="msau.train_step")
