"""The caching allocator's device calls a step (``cudaMalloc`` +
``cudaFree``: ``torch.cuda.memory_stats`` over ``msau.train_step``, the
program's counter ``allocator_calls``) in the traced window; a
``cudaFree`` waits for the device."""

from benchmark.spans import per_unit


def read(ctx):
    return per_unit(ctx, counter="allocator_calls")
