"""Seconds from the process's start to the first timed step: imports, the
kernel library's build or load, weights, inputs, the program and its first
steps."""


def read(ctx):
    return getattr(ctx, "setup_s", None)
