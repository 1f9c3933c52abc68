"""Images trained per second: every image of every step in the window, over
the window's time on the host clock (from the first step's launch to the
closing fetch)."""


def read(ctx):
    return ctx.units * ctx.work["images"] / ctx.window_s
