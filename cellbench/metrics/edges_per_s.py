"""Edges of the ticks completed in the window over the window's wall
time (host clock)."""


def read(ctx):
    return ctx.window_edges / ctx.window_s if ctx.window_s > 0 else None
