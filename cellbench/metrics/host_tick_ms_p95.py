"""The 95th percentile of the wall time of the window's ticks after the
profiled part (``trace.PROFILED_S``), each from the end of the tick
before it to its last delivered match (host clock).  A per-layer number:
the window serves a backlog, so ``edges_per_s`` is the end-to-end
number."""

import numpy as np


def read(ctx):
    ticks = ctx.tick_s[ctx.quiet_from:]
    return float(np.percentile(ticks, 95)) * 1e3 if ticks else None
