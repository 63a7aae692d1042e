"""Host milliseconds a tick spends advancing the shared prefix forest
(tracer span ``tick.forest``), where the forest has nodes."""

from cellbench.metrics._spans import per_tick_ms


def read(ctx):
    return per_tick_ms(ctx, "tick.forest",
                       need=lambda s: s.get("n_nodes", 0) > 0)
