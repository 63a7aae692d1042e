"""One run of one cell: set-up, the measured window, the check.

A cell is a configuration (``configs/<name>.json``: the stream, the
tenants, the service's capacities) under a traffic mix
(``traffic/<name>.json``: the batch, the warm-up, the stream's length).
The run makes the stream from the seed, registers the tenants on a
``repro_torch.api.StreamSession``, warms it up over one span of the
widest window, then serves the backlog through ``StreamSession.serve``,
one call a tick at the fixed batch, until ``seconds`` have passed.  A
tick runs from the end of the tick before it (the window's start for
the first) to its ``on_tick`` callback, which the service makes after
the last match of the tick is delivered, so the ticks sum to the window.

After the window the program's state is freed and the plain reference
(``reference/matches.py``) recomputes every tenant's matches over the
served stream; every delivered match of every tick is compared.

The metrics are read by files of their own under ``metrics/``, named as
in ``BENCHMARK.json``: each has ``read(ctx)``, returning a number or
None where it has nothing to read.  With ``trace`` the program's tracer
records its spans over the window, and the profiler records the
window's first ``trace.PROFILED_S`` seconds (``trace.py``); the
per-layer readers read the profile, and the host clock and the spans of
the ticks after it, which the profiler does not slow.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from collections import Counter

import numpy as np

from cellbench import gen, tenants
from cellbench.reference.matches import pattern_matches

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def stream_length(cfg: dict, traffic: dict, seconds: float):
    """``(edges the run makes, warm-up ticks)``: the warm-up serves one
    span of the widest window and a tick, the window ``seconds`` at the
    traffic's ceiling rate (a margin over the highest rate measured), in
    whole ticks.  A run that serves them all before ``seconds`` ends its
    window there and says so."""
    b = traffic["batch"]
    span = max(t["window"] for t in cfg["tenants"])
    mean_step = cfg["stream"]["ts_step_max"] / 2
    warm = math.ceil(span / mean_step / b) + 1
    window = math.ceil(seconds * traffic["ceiling_edges_per_s"] / b)
    return (warm + window) * b, warm


def make_session(cfg: dict, device, tracer=None, max_new=None):
    from repro_torch.api import StreamSession
    from repro_torch.core.multi import SlotTickCache

    sv = cfg["service"]
    return StreamSession(
        slots_per_group=sv["slots_per_group"],
        level_capacity=sv["level_capacity"], l0_capacity=sv["l0_capacity"],
        max_new=sv["max_new"] if max_new is None else max_new,
        share_prefixes=sv["share_prefixes"], tick_cache=SlotTickCache(),
        tracer=tracer, device=device)


class Run:
    """What one run saw: the host clock, the program's reports, and
    (traced) its spans and profile.  ``ctx`` for the metric readers."""

    def __init__(self):
        self.setup_s = None
        self.tick_s = []            # each window tick's seconds
        self.window_edges = 0
        self.window_s = 0.0
        self.exhausted = False
        self.overflow = []          # every served tick's n_overflow
        self.chunks = []            # every served tick's edges
        self.warm_ticks = 0
        self.quiet_from = 0         # first window tick the profiler left
        self.spans = []             # tracer records of those ticks
        self.trace = None           # Profile.summary() (traced run)
        self.memory_peak_bytes = None
        self.n_matches = 0          # matches delivered, warm-up included
        self.tenant_matches = {}    # the same, by tenant


def serve_window(sess, chunks, t_start, seconds, run, on_tick_extra=None,
                 between=None):
    """Serve ``chunks`` one ``StreamSession.serve`` call a tick from
    ``t_start`` until ``seconds`` have passed; returns the ticks
    served.  ``between(ticks, seconds)`` runs before each call."""
    b = len(chunks[0])
    stamps = [t_start]

    def on_tick(info):
        stamps.append(time.perf_counter())
        run.overflow.append(info.n_overflow)
        run.chunks.append(info.chunk)
        if on_tick_extra is not None:
            on_tick_extra()

    n = 0
    for chunk in chunks:
        if stamps[-1] - t_start >= seconds:
            break
        if between is not None:
            between(n, stamps[-1] - t_start)
        sess.serve(chunk, batch_size=b, min_batch=b, max_batch=b,
                   on_tick=on_tick, final_checkpoint=False)
        n += 1
    else:
        run.exhausted = stamps[-1] - t_start < seconds
    run.tick_s = list(np.diff(stamps))
    run.window_s = stamps[-1] - t_start
    return n


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, *, device, t_process=None, max_new=None):
    """One run; returns ``(run, check)``.  ``check`` holds the numbers
    compared with their limits.  ``max_new`` (the control) overrides the
    configuration's pair budget."""
    import torch

    t0 = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    run = Run()
    n_edges, warm = stream_length(cfg, traffic, seconds)
    st = dict(cfg["stream"])
    social = st.pop("generator") == "social"
    cols = gen.stream_columns(n_edges, seed, social=social, **st)
    specs = cfg["tenants"]
    b = traffic["batch"]

    tracer = spans_buf = None
    if trace:
        from repro_torch.obs.trace import memory_tracer
        tracer, spans_buf = memory_tracer()
    sess = make_session(cfg, device, tracer=tracer, max_new=max_new)
    got = []                        # per tenant: delivered Match records
    for spec in specs:
        sub = sess.register(tenants.pattern(spec))
        got.append([])
        sub.on_match = got[-1].append
    gc.disable()
    chunks = [gen.edges(cols, i, i + b) for i in range(0, n_edges, b)]
    gc.freeze()                     # the stream is never garbage
    gc.enable()
    # per tick, the number of matches each tenant had received by its end
    marks = []

    def mark():
        marks.append([len(g) for g in got])

    # warm-up: one span of the widest window, so the tables are full
    for chunk in chunks[:warm]:
        sess.serve(chunk, batch_size=b, min_batch=b, max_batch=b,
                   on_tick=lambda info: (run.overflow.append(
                       info.n_overflow), run.chunks.append(info.chunk),
                       mark()), final_checkpoint=False)
    run.warm_ticks = warm
    if cuda:
        torch.cuda.synchronize()
    # what set-up left behind is not the window's to collect
    gc.collect()
    gc.freeze()
    if tracer is not None:
        spans_buf.seek(0)
        spans_buf.truncate()
    run.setup_s = time.perf_counter() - t0

    window_chunks = chunks[warm:]
    if trace:
        from cellbench import trace as T
        prof = T.Profile(torch, cuda)

        def between(ticks, elapsed):
            if elapsed >= T.PROFILED_S:
                prof.stop(ticks)
        try:
            n = serve_window(sess, window_chunks, prof.start(), seconds,
                             run, mark, between)
        finally:
            prof.stop(n_ticks=len(run.chunks) - warm)
        spans = T.read_spans(spans_buf)
        run.trace = prof.summary(spans)
        # the tick after the profiled ones also pays the profiler's stop
        run.quiet_from = prof.n_ticks + 1
        run.spans = [s for s in spans
                     if s["tick"] - spans[0]["tick"] >= run.quiet_from]
    else:
        n = serve_window(sess, window_chunks, time.perf_counter(), seconds,
                         run, mark)
    if cuda:
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.window_edges = sum(run.chunks[warm:])
    if run.exhausted:
        print(f"the stream ran out after {n} window ticks, "
              f"{run.window_s:.3f} s: metrics are over the time served",
              file=sys.stderr)

    run.n_matches = sum(len(g) for g in got)
    run.tenant_matches = {s["name"]: len(g) for s, g in zip(specs, got)}
    # free the program's state before the reference runs
    served = (warm + n) * b
    del sess, chunks, window_chunks
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = compare(cols, served, b, specs, got, marks, run)
    return run, check


def _rows(matches: list, tick_of: np.ndarray) -> Counter:
    return Counter(
        (int(t),) + tuple(v for _, v in m.vertices)
        + tuple(ts for _, ts in m.edges)
        for t, m in zip(tick_of, matches))


def compare(cols, served, batch, specs, got, marks, run) -> dict:
    """The numbers compared, each with its limit: matches that the
    program and the reference do not share (as multisets of tick,
    bindings, edge timestamps), and dropped appends."""
    marks = np.asarray(marks, np.int64).reshape(-1, len(specs))
    n_ticks = served // batch
    if len(marks) != n_ticks:
        raise RuntimeError(f"{len(marks)} tick marks for {n_ticks} ticks")
    mismatched = 0
    for k, spec in enumerate(specs):
        n = len(got[k])
        tick_of = np.searchsorted(marks[:, k], np.arange(n), side="right")
        have = _rows(got[k], tick_of)
        want = Counter(map(tuple, pattern_matches(cols, served, batch,
                                                  spec).tolist()))
        mismatched += sum((have - want).values()) \
            + sum((want - have).values())
    return {"mismatched_matches": {"value": mismatched, "limit": 0},
            "n_overflow": {"value": int(sum(run.overflow)), "limit": 0}}


def load_reader(name: str):
    """``metrics/<name>.py``'s module."""
    return importlib.import_module(f"cellbench.metrics.{name}")
