"""The most device memory the program and its inputs held over set-up and
the window, in GiB (``torch.cuda.max_memory_allocated``)."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
