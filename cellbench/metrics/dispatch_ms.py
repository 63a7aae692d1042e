"""Host milliseconds a tick spends dispatching the prefix forest and
every slot group (tracer spans ``tick.forest`` and
``tick.slot_dispatch`` of ``runtime/service.py`` ``_tick_chunk``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "tick.forest", "tick.slot_dispatch")
