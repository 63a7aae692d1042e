"""Host milliseconds a tick spends converting the served events to the
engine's edges (tracer span ``api.convert`` of ``api/session.py``
``StreamSession.serve``)."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "api.convert")
