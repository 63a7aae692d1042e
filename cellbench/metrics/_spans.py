"""Per-tick milliseconds of the program's tracer spans."""


def per_tick_ms(ctx, *names, need=None):
    """The named spans' milliseconds summed over the ticks after the
    profiled part of the window, over those ticks; None without spans,
    or where ``need(span)`` holds for none of them."""
    spans = [s for s in ctx.spans if s["span"] in names]
    if not spans or (need is not None and not any(map(need, spans))):
        return None
    return sum(s["ms"] for s in spans) / len({s["tick"] for s in ctx.spans})
