"""Device kernels launched in the traced window over its ticks
(``torch.profiler``; the benchmark's own counting kernels left out)."""


def read(ctx):
    t = ctx.trace
    return t.launches / t.n_ticks if t is not None and t.n_ticks else None
