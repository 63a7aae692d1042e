"""Host milliseconds a tick spends reading every group's result rows and
delivering its matches as the api's ``Match`` records (tracer spans
``deliver.matches``, one a group, inside ``tick.deliver``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "deliver.matches")
