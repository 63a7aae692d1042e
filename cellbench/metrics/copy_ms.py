"""Host milliseconds a tick spends copying every group's whole result to
the host (tracer spans ``deliver.copy``, one a group, inside
``tick.deliver``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "deliver.copy")
