"""Host milliseconds a tick spends building the padded edge batch and
copying it to the device (tracer span ``tick.batch`` of
``runtime/service.py`` ``_tick_chunk``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "tick.batch")
