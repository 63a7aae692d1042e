"""Megabytes (10^6 B) of result copied to the host a tick: the ``bytes``
of the tracer spans ``deliver.copy`` (every group's result leaves, from
their metadata) over the ticks after the profiled part of the window."""


def read(ctx):
    copies = [s for s in ctx.spans
              if s["span"] == "deliver.copy" and "bytes" in s]
    if not copies:
        return None
    return sum(s["bytes"] for s in copies) / 1e6 \
        / len({s["tick"] for s in ctx.spans})
