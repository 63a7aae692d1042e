"""Structured host-side tracing: span timers emitting a JSONL trace.

A :class:`Tracer` wraps serve-loop stages (the api's event conversion,
frontier poll, watermark release, the batch build, forest node tick,
slot dispatch, the barrier, delivery with its result copy and match
records, coalescer decision, checkpoint publish, mesh collectives) in
wall-clock span timers and appends one JSON object per span to a
file::

    {"tick": 17, "span": "tick.slot", "ms": 0.42,
     "t0": 1723190400.123, "start_ns": 1723190400122612345, "gid": 0}

``tick`` is the per-tick correlation id — every span recorded between
two ``next_tick()`` calls shares it, so the summarize CLI can
reconstruct where each tick's time went across layers.  ``t0`` is the
span's end on the wall clock (the reference's format, in seconds to the
millisecond); ``start_ns`` is the span's start in CLOCK_REALTIME
nanoseconds, the clock ``torch.profiler`` stamps its events in (an
event's time plus the profile's ``trace_start_ns()``), so spans and a
profile of the same run share one time axis.  The serve loop reports
a tick's stages after delivering it, so the file is in the order of the
reports, not of the starts: ``start_ns`` orders them.

Tracing is OFF by default and the serve loop guards every call site
with ``if tracer is not None``: when disabled, zero span objects are
allocated and zero clock reads happen.  All of this is host-only
Python: a span's body may *contain* a device sync, but the timer never
adds one.
"""

from __future__ import annotations

import io
import json
import time
from typing import IO

__all__ = ["Tracer", "Span"]


class Span:
    """One timed stage.  Use via ``with tracer.span("tick.slot"): ...``."""

    __slots__ = ("tracer", "name", "fields", "t0")

    def __init__(self, tracer: "Tracer", name: str, fields: dict):
        self.tracer = tracer
        self.name = name
        self.fields = fields
        self.t0 = 0.0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        ms = (time.perf_counter() - self.t0) * 1e3
        self.tracer._emit(self.name, ms, self.fields, self.t0)


class Tracer:
    """JSONL span emitter with per-tick correlation ids.

    ``sink`` is a path or an open text file.  Writes are buffered by the
    underlying file object; call :meth:`flush`/:meth:`close` (the
    service does on checkpoint and shutdown) before reading the file.
    """

    def __init__(self, sink: str | IO[str]):
        if isinstance(sink, (str, bytes)):
            self._fh: IO[str] = open(sink, "w")
            self._owns = True
        else:
            self._fh = sink
            self._owns = False
        self.tick = 0
        self.n_spans = 0
        self._sync_clock()

    def _sync_clock(self) -> None:
        # perf_counter ns -> CLOCK_REALTIME ns; refreshed every tick so
        # that a step of the wall clock reaches the records within one
        self._ns_offset = time.time_ns() - time.perf_counter_ns()

    # ----------------------------------------------------------- #
    def next_tick(self) -> int:
        """Advance the correlation id; returns the new tick id."""
        self.tick += 1
        self._sync_clock()
        return self.tick

    def span(self, name: str, **fields) -> Span:
        return Span(self, name, fields)

    def record(self, name: str, ms: float, *, start: float | None = None,
               **fields) -> None:
        """Post-hoc span: the serve loop times stages with bare
        ``perf_counter`` reads and reports them here, so the tracer-off
        path needs no Span objects (and no allocation) at all.
        ``start`` is the stage's starting ``perf_counter()`` reading
        (without it the span is taken to end now); a ``tick`` field
        overrides the correlation id."""
        self._emit(name, ms, fields, start)

    def event(self, name: str, **fields) -> None:
        """Zero-duration marker (e.g. ``coalescer.decision``)."""
        self._emit(name, 0.0, fields)

    def _emit(self, name: str, ms: float, fields: dict,
              start: float | None = None) -> None:
        if start is None:           # the span ends now
            end_ns = time.time_ns()
            start_ns = end_ns - round(ms * 1e6)
        else:
            start_ns = round(start * 1e9) + self._ns_offset
            end_ns = start_ns + round(ms * 1e6)
        rec = {"tick": self.tick, "span": name, "ms": round(ms, 4),
               "t0": round(end_ns / 1e9, 3), "start_ns": start_ns}
        if fields:
            rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self.n_spans += 1

    # ----------------------------------------------------------- #
    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self.flush()
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def memory_tracer() -> tuple[Tracer, io.StringIO]:
    """In-memory tracer for tests: (tracer, its StringIO buffer)."""
    buf = io.StringIO()
    return Tracer(buf), buf
