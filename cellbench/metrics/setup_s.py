"""Process start to the window's start: the stream, the session, the
tenants, the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
