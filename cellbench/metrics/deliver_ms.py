"""Host milliseconds a tick spends copying every group's result to the
host and delivering its matches (tracer span ``tick.deliver``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "tick.deliver")
