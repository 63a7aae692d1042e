"""Fault-tolerant ingestion frontier: sources -> merge -> watermark -> engine.

The port of ``repro.stream.ingest`` (host Python, a faithful copy over
the port's ``DataEdge``: the same merge order, counters and manifest,
key for key, so a frontier manifest written by either package resumes
in the other).

The engine (``ContinuousSearchService``) consumes pre-ordered in-process
batches; production streams arrive over flaky transports, interleaved
across sources, late, and occasionally backwards.  This module is the
boundary that turns that traffic into the ordered, exactly-once stream
the paper assumes:

* ``Source``          the transport protocol: ``connect(resume_from)`` /
  ``poll(max_events)`` / ``close()``.  A transport failure raises
  ``SourceDisconnected``; events carry a per-source sequence cursor
  (``SourceEvent.seq``) so a reconnect can resume without loss.
  ``ScriptedSource`` replays a deterministic delivery script (seq may
  repeat = duplicate delivery, arrive out of order = reordering);
  ``ListSource`` is the identity script over a ``DataEdge`` list.
* ``SourceAdapter``   wraps a ``Source`` with bounded retry + exponential
  backoff (``repro_torch.runtime.fault.RetryPolicy`` — the same policy
  object ``FaultTolerantLoop`` uses for restarts), reconnect-with-resume from
  the sequence cursor, and duplicate suppression with counted dedups
  (``SeqTracker``): every suppressed delivery is counted, never silent.
* ``IngestFrontier``  the deterministic k-way event-time merge + the
  watermark.  Merge ties break by the btengine ladder:
  event_time -> received_time (when a transport stamps one) ->
  deterministic event metadata (the full edge payload) -> source order
  -> sequence.  A bounded reorder buffer holds events until the
  watermark (min over live sources of max-event-time, minus
  ``allowed_lateness``) passes them; events arriving later than the
  allowed lateness are dropped AND counted (``n_late_dropped``,
  ``on("drop_late")``).  ``strict_event_time_monotonic=True`` is the
  fail-fast alternative: any per-source event-time regression raises
  ``MonotonicityError`` instead of being buffered.
* exactly-once resume: ``to_manifest()`` captures per-source ack cursors
  (contiguous floor + sparse extras for out-of-order emission) and the
  emit floor; it rides inside service checkpoints
  (``ContinuousSearchService._manifest()["ingest"]``), and
  ``IngestFrontier.resume(manifest, sources)`` reconnects every source
  at its cursor — replayed deliveries of already-ingested events are
  suppressed by the restored trackers, so a crash/restore through the
  ingest layer yields the exact match multiset of an uninterrupted run
  (tests/test_torch_ingest.py).

``merge_event_streams`` is the offline k-way merge over already-ordered
lists (the same tie-break ladder, property-tested in
tests/test_torch_ingest.py).  ``CallbackRegistry`` is the subscription
surface: ``frontier.on("event" | "drop_late" | "drop_forced_gap" |
"duplicate" | "reconnect" | "stall", fn)``.

Everything here is host-side, deterministic Python: time and sleep are
injectable, jitter draws from a seeded rng, and the chaos harness
(``repro_torch.stream.chaos``) scripts its faults from a seed — so every test
and benchmark over this layer is reproducible.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np

from repro_torch.core.oracle import DataEdge
from repro_torch.runtime.fault import RetryPolicy

# adapter / source lifecycle states
CONNECTED = "connected"
RETRYING = "retrying"
FAILED = "failed"
EXHAUSTED = "exhausted"


class IngestError(RuntimeError):
    """Unrecoverable ingest failure (retry budget exhausted, bad resume)."""


class SourceDisconnected(RuntimeError):
    """Transient transport failure: the adapter reconnects with backoff."""


class MonotonicityError(IngestError):
    """strict_event_time_monotonic: a source's event time went backwards."""


@dataclass(frozen=True)
class SourceEvent:
    """One delivery from a transport.

    ``seq`` is the source's own sequence cursor — contiguous per source
    in canonical order, NOT necessarily in delivery order (reordering)
    and not necessarily unique across deliveries (duplicate delivery).
    ``recv_ts`` is the transport's received-time stamp when it has one;
    in-process replays leave it None and the merge ladder skips it.
    """

    edge: DataEdge
    seq: int
    recv_ts: int | None = None

    @property
    def ts(self) -> int:
        return self.edge.ts


class Source:
    """Transport protocol.  Implementations must be resumable: after
    ``connect(resume_from=c)``, every event with ``seq >= c`` that has
    not been delivered since that connect must (eventually) be delivered
    again; deliveries with ``seq < c`` are allowed (at-least-once) and
    suppressed downstream."""

    name: str = "source"

    def connect(self, resume_from: int = 0) -> None:
        raise NotImplementedError

    def poll(self, max_events: int = 64) -> list[SourceEvent]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def exhausted(self) -> bool:
        return False


class ScriptedSource(Source):
    """Deterministic transport: replays a delivery script of
    ``(seq, DataEdge)`` pairs in order.  The script may repeat seqs
    (duplicate delivery) and deliver them out of canonical order
    (reordering) — ``repro_torch.stream.generator.disordered_sources`` builds
    such scripts from one seeded traffic model.

    ``connect(resume_from)`` rewinds to the earliest script position
    holding any ``seq >= resume_from``; earlier-seq entries after that
    position are simply delivered again (at-least-once) and suppressed
    by the adapter's tracker.
    """

    def __init__(self, name: str, script: list[tuple[int, DataEdge]]):
        self.name = name
        self._script = list(script)
        self._pos = 0
        self._connected = False

    def connect(self, resume_from: int = 0) -> None:
        self._pos = next(
            (i for i, (s, _) in enumerate(self._script) if s >= resume_from),
            len(self._script))
        self._connected = True

    def poll(self, max_events: int = 64) -> list[SourceEvent]:
        if not self._connected:
            raise SourceDisconnected(f"{self.name}: poll before connect")
        out = [SourceEvent(edge=e, seq=s)
               for s, e in self._script[self._pos:self._pos + max_events]]
        self._pos += len(out)
        return out

    def close(self) -> None:
        self._connected = False

    @property
    def exhausted(self) -> bool:
        return self._connected and self._pos >= len(self._script)


class ListSource(ScriptedSource):
    """The identity script: deliver a ``DataEdge`` list in order, seq =
    list index."""

    def __init__(self, name: str, edges: Iterable[DataEdge]):
        super().__init__(name, [(i, e) for i, e in enumerate(edges)])


class CallbackRegistry:
    """Subscription registry for ingest lifecycle events.

    Kinds: ``event`` (one emitted DataEdge), ``drop_late`` (source name,
    edge, seq), ``drop_forced_gap`` (source name, edge, seq: dropped
    because forced evictions advanced the emit floor past the watermark
    — capacity pressure, not user-visible lateness), ``duplicate``
    (source name, seq), ``reconnect`` (source name, attempt, delay_s),
    ``stall`` (source name, rounds), ``watermark`` (new watermark).
    Unknown kinds are rejected loudly — a typo'd subscription must not
    become a silent no-listener.
    """

    KINDS = ("event", "drop_late", "drop_forced_gap", "duplicate",
             "reconnect", "stall", "watermark")

    def __init__(self):
        self._subs: dict[str, list[Callable]] = {k: [] for k in self.KINDS}

    def on(self, kind: str, fn: Callable) -> Callable:
        if kind not in self._subs:
            raise ValueError(
                f"unknown callback kind {kind!r}; one of {self.KINDS}")
        self._subs[kind].append(fn)
        return fn

    def emit(self, kind: str, *args) -> None:
        for fn in self._subs[kind]:
            fn(*args)


class SeqTracker:
    """Which sequence numbers of one source have been seen/acked:
    a contiguous floor (all ``seq < floor`` seen) plus a sparse set of
    out-of-order extras above it.  ``add`` returns False for an
    already-seen seq (= duplicate delivery)."""

    def __init__(self, floor: int = 0, extras: Iterable[int] = ()):
        self.floor = floor
        self.extras = set(extras)
        self._compact()

    def _compact(self) -> None:
        while self.floor in self.extras:
            self.extras.discard(self.floor)
            self.floor += 1

    def add(self, seq: int) -> bool:
        if seq < self.floor or seq in self.extras:
            return False
        if seq == self.floor:
            self.floor += 1
            self._compact()
        else:
            self.extras.add(seq)
        return True

    def __contains__(self, seq: int) -> bool:
        return seq < self.floor or seq in self.extras

    def to_manifest(self) -> dict:
        return {"floor": self.floor, "extras": sorted(self.extras)}

    @classmethod
    def from_manifest(cls, man: dict) -> "SeqTracker":
        return cls(int(man["floor"]), (int(x) for x in man["extras"]))


class SourceAdapter:
    """One source behind retry/backoff, reconnect-with-resume, and
    counted duplicate suppression.

    ``pull(max_events)`` polls the source; a ``SourceDisconnected`` from
    ``poll`` (or ``connect``) triggers reconnect-with-resume from the
    tracker's floor, with delays from the shared ``RetryPolicy``
    (injectable ``sleep``; jitter from the seeded rng).  When the retry
    budget is exhausted the adapter enters ``FAILED`` and raises
    ``IngestError`` — a dead source is loud, never a silent stall.
    Deliveries whose seq the tracker has already seen are suppressed and
    counted in ``n_duplicates``.
    """

    def __init__(
        self,
        source: Source,
        retry: RetryPolicy | None = None,
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
        callbacks: CallbackRegistry | None = None,
        tracker: SeqTracker | None = None,
    ):
        self.source = source
        self.retry = retry if retry is not None else RetryPolicy()
        self.sleep = sleep
        self.rng = np.random.default_rng(seed)
        self.callbacks = callbacks
        self.seen = tracker if tracker is not None else SeqTracker()
        # acked = delivered DOWNSTREAM to the engine (or counted as a
        # late drop): the durable cursor that rides in checkpoints.
        # ``seen`` additionally covers pulled-but-unemitted events; it
        # is rebuilt from ``acked`` on resume (lost buffer = replayed).
        self.acked = SeqTracker(self.seen.floor, self.seen.extras)
        self.state = RETRYING
        self.high: int | None = None      # max event ts seen (watermark input)
        self.last_ts: int | None = None   # last pulled ts (strict mode)
        self.stall_rounds = 0
        self.n_events = 0
        self.n_duplicates = 0
        self.n_reconnects = 0
        self.n_retries = 0
        self._connect(initial=True)

    @property
    def name(self) -> str:
        return self.source.name

    @property
    def exhausted(self) -> bool:
        # FAILED is terminal for exhaustion: the retry budget is spent
        # and this adapter will never produce again, so it must not hold
        # ``IngestFrontier.exhausted`` open forever (a caller that
        # swallowed the IngestError and kept serving would busy-loop on
        # empty rounds).  It stays loud in ``stats()`` via its state and
        # ``n_failed_sources``.
        return self.state in (EXHAUSTED, FAILED) or (
            self.state == CONNECTED and self.source.exhausted)

    def _connect(self, initial: bool = False) -> None:
        attempt = 0
        while True:
            try:
                self.source.connect(resume_from=self.seen.floor)
                self.state = CONNECTED
                if not initial:
                    self.n_reconnects += 1
                return
            except SourceDisconnected:
                attempt += 1
                self._backoff(attempt)

    def _backoff(self, attempt: int) -> None:
        self.n_retries += 1
        if self.retry.exhausted(attempt):
            self.state = FAILED
            raise IngestError(
                f"source {self.name!r}: retry budget exhausted after "
                f"{attempt - 1} reconnect attempts")
        self.state = RETRYING
        delay = self.retry.delay(attempt, self.rng)
        if self.callbacks is not None:
            self.callbacks.emit("reconnect", self.name, attempt, delay)
        self.sleep(delay)

    def pull(self, max_events: int = 64) -> list[SourceEvent]:
        """Poll once (reconnecting through failures); returns the new,
        deduplicated deliveries."""
        if self.state == FAILED:
            raise IngestError(f"source {self.name!r} is failed")
        attempt = 0
        while True:
            try:
                raw = self.source.poll(max_events)
                break
            except SourceDisconnected:
                attempt += 1
                self._backoff(attempt)
                self._connect()
        out = []
        for ev in raw:
            if not self.seen.add(ev.seq):
                self.n_duplicates += 1
                if self.callbacks is not None:
                    self.callbacks.emit("duplicate", self.name, ev.seq)
                continue
            self.n_events += 1
            self.high = ev.ts if self.high is None else max(self.high, ev.ts)
            out.append(ev)
        if self.source.exhausted:
            self.state = EXHAUSTED
        self.stall_rounds = 0 if raw else self.stall_rounds + 1
        return out

    def ack(self, seq: int) -> None:
        self.acked.add(seq)


class IngestStats(dict):
    """Counters of the whole frontier (attribute access for ergonomics)."""

    __getattr__ = dict.__getitem__


def _ladder_key(ev: SourceEvent, src_idx: int):
    """The btengine tie-break ladder: event_time -> received_time (when
    stamped) -> deterministic event metadata (full edge payload) ->
    source order -> sequence.  Total and deterministic: two deliveries
    compare equal only if they are payload-identical, in which case
    either order is the same merged sequence."""
    e = ev.edge
    return (e.ts,
            0 if ev.recv_ts is None else ev.recv_ts,
            (e.src, e.dst, e.edge_label, e.src_label, e.dst_label),
            src_idx,
            ev.seq)


def merge_event_streams(
    streams: list[list[DataEdge]],
    strict_event_time_monotonic: bool = False,
) -> list[DataEdge]:
    """Offline deterministic k-way merge of per-source ordered lists.

    Each input list must be ordered by event time (``strict...=True``
    raises ``MonotonicityError`` on any regression; the default tolerates
    equal-ts plateaus and silently ACCEPTS unordered inputs the way a
    heap merge does — callers with disorder want ``IngestFrontier``).
    Ties across streams break by the ladder, so the merged order is
    independent of the order the streams are listed in (property-tested).
    """
    for si, s in enumerate(streams):
        for a, b in zip(s, s[1:]):
            if b.ts < a.ts:
                if strict_event_time_monotonic:
                    raise MonotonicityError(
                        f"stream {si}: event time regressed "
                        f"{a.ts} -> {b.ts}")
    heap = []
    for si, s in enumerate(streams):
        for i, e in enumerate(s):
            heap.append((_ladder_key(SourceEvent(e, i), si)[:3] + (i,), e))
    # source index is dropped from the sort key ABOVE the sequence so
    # listing order cannot leak into the merged order; payload-identical
    # ties are interchangeable anyway
    heap.sort(key=lambda t: t[0])
    return [e for _, e in heap]


# Internal "every source is done: drain the buffer" release bound.  Big
# enough that every real event timestamp is at-or-below it; it never
# leaves the frontier (``watermark()`` surfaces real timestamps or None).
_DRAIN = 2 ** 63 - 1


class IngestFrontier:
    """K-way event-time merge + watermarked reorder buffer over N
    fault-wrapped sources; the producer side of
    ``ContinuousSearchService.serve_frontier``.

    ``pump()`` pulls a round from every live source into the reorder
    buffer (heap on the ladder key); ``take_ready(limit)`` pops every
    buffered event at or below the watermark — min over live sources of
    their max seen event time, minus ``allowed_lateness`` — in merged
    order, advancing the emit floor.  An event arriving with
    ``ts < emit_floor`` is later than the allowed lateness: it is
    dropped and counted (never silent).  A source that stalls for more
    than ``stall_patience`` consecutive empty rounds stops holding the
    watermark back (counted + ``on("stall")``) until it produces again.
    If the buffer exceeds ``reorder_capacity`` the oldest events are
    force-emitted past the watermark (counted in ``n_forced``).
    """

    def __init__(
        self,
        sources: Iterable[Source | SourceAdapter],
        allowed_lateness: int = 0,
        reorder_capacity: int = 4096,
        strict_event_time_monotonic: bool = False,
        stall_patience: int = 8,
        retry: RetryPolicy | None = None,
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
        _resume: dict | None = None,
    ):
        if allowed_lateness < 0 or reorder_capacity < 1:
            raise ValueError(
                "need allowed_lateness >= 0 and reorder_capacity >= 1")
        self.allowed_lateness = allowed_lateness
        self.reorder_capacity = reorder_capacity
        self.strict = strict_event_time_monotonic
        self.stall_patience = stall_patience
        self.callbacks = CallbackRegistry()
        cursors = {} if _resume is None else {
            s["name"]: SeqTracker.from_manifest(s)
            for s in _resume["sources"]}
        self.adapters: list[SourceAdapter] = []
        for i, s in enumerate(sources):
            if isinstance(s, SourceAdapter):
                s.callbacks = self.callbacks
                self.adapters.append(s)
            else:
                self.adapters.append(SourceAdapter(
                    s, retry=retry, sleep=sleep, seed=seed + i,
                    callbacks=self.callbacks,
                    tracker=cursors.get(s.name)))
        names = [a.name for a in self.adapters]
        if len(set(names)) != len(names):
            raise IngestError(
                f"source names must be unique (resume cursors key on "
                f"them): {names}")
        if _resume is not None:
            missing = set(cursors) - set(names)
            if missing:
                raise IngestError(
                    f"resume manifest names sources not provided: "
                    f"{sorted(missing)}")
        self._heap: list[tuple[tuple, int, SourceEvent]] = []
        self.emit_floor: int | None = None
        self.n_emitted = 0
        self.n_late_dropped = 0
        self.n_dropped_forced_gap = 0
        self.n_forced = 0
        self.n_stalled_rounds = 0
        # monotone event-time watermark floor: the highest finite release
        # bound ever observed (persisted in the manifest, so a restored
        # frontier's clock can never regress below the checkpoint's)
        self._wm_floor: int | None = None
        if _resume is not None:
            self.emit_floor = _resume.get("emit_floor")
            self._wm_floor = _resume.get("watermark")
            c = _resume.get("counters", {})
            self.n_emitted = int(c.get("n_emitted", 0))
            self.n_late_dropped = int(c.get("n_late_dropped", 0))
            self.n_dropped_forced_gap = int(
                c.get("n_dropped_forced_gap", 0))
            self.n_forced = int(c.get("n_forced", 0))

    # ------------------------------------------------------------------ #
    def on(self, kind: str, fn: Callable) -> Callable:
        """Subscribe to ingest lifecycle events (``CallbackRegistry``)."""
        return self.callbacks.on(kind, fn)

    @property
    def buffered(self) -> int:
        return len(self._heap)

    @property
    def exhausted(self) -> bool:
        return not self._heap and all(a.exhausted for a in self.adapters)

    # ------------------------------------------------------------------ #
    def pump(self, max_per_source: int = 64) -> int:
        """One pull round over every live source; buffers (or late-drops)
        the new deliveries.  Returns how many entered the buffer."""
        n_in = 0
        for si, a in enumerate(self.adapters):
            if a.exhausted:                # includes terminal FAILED
                continue
            evs = a.pull(max_per_source)
            if not evs and a.stall_rounds == self.stall_patience + 1:
                self.callbacks.emit("stall", a.name, a.stall_rounds)
            if a.stall_rounds > self.stall_patience:
                self.n_stalled_rounds += 1
            for ev in evs:
                if self.strict and a.last_ts is not None \
                        and ev.ts < a.last_ts:
                    raise MonotonicityError(
                        f"source {a.name!r}: event time regressed "
                        f"{a.last_ts} -> {ev.ts} "
                        "(strict_event_time_monotonic)")
                a.last_ts = ev.ts
                if self.emit_floor is not None and ev.ts < self.emit_floor:
                    # the merged stream already advanced past this event
                    # time.  Dropped, counted, acked (accounted-for =
                    # consumed) — but attributed by CAUSE: at-or-below
                    # the watermark means the event really arrived later
                    # than the allowed lateness; above it means forced
                    # evictions (reorder-buffer capacity) advanced the
                    # emit floor past the watermark, which is capacity
                    # pressure, not user-visible lateness.
                    wm = self.watermark()
                    if wm is not None and ev.ts <= wm:
                        self.n_late_dropped += 1
                        kind = "drop_late"
                    else:
                        self.n_dropped_forced_gap += 1
                        kind = "drop_forced_gap"
                    a.ack(ev.seq)
                    self.callbacks.emit(kind, a.name, ev.edge, ev.seq)
                    continue
                heapq.heappush(self._heap, (_ladder_key(ev, si), si, ev))
                n_in += 1
        return n_in

    def _release_bound(self) -> int | None:
        """Internal release gate for ``take_ready``: min over live
        (non-exhausted, non-stalled-out) sources of the max event time
        seen, minus the allowed lateness.  None while any live source has
        produced nothing yet (nothing is safe to emit); the ``_DRAIN``
        sentinel when no live source remains (drain the buffer)."""
        highs = []
        for a in self.adapters:
            if a.exhausted:
                continue
            if a.stall_rounds > self.stall_patience:
                continue      # stalled out: stops holding the line back
            if a.high is None:
                return None   # a live source with no data yet: hold all
            highs.append(a.high)
        if not highs:
            return _DRAIN                 # every source done: drain
        return min(highs) - self.allowed_lateness

    def watermark(self) -> int | None:
        """The frontier's event-time watermark: a monotone, None-safe
        clock for stats, health hooks, and the engine's event-time tick
        input.  ``None`` until any release bound is known; thereafter the
        highest finite release bound observed — and, once every source
        is done, the emit floor (all events released ⇒ event time has
        advanced to everything emitted).  Never the internal ``_DRAIN``
        sentinel: downstream consumers see real event timestamps only.
        """
        b = self._release_bound()
        if b is not None and b != _DRAIN:
            if self._wm_floor is None or b > self._wm_floor:
                self._wm_floor = b
        elif b == _DRAIN and self.emit_floor is not None:
            if self._wm_floor is None or self.emit_floor > self._wm_floor:
                self._wm_floor = self.emit_floor
        return self._wm_floor

    def take_ready(self, limit: int | None = None) -> list[DataEdge]:
        """Pop emit-ready events in merged order: everything at or below
        the release bound, plus forced evictions while the buffer exceeds
        ``reorder_capacity``.  Advances the emit floor; acks each."""
        wm = self._release_bound()
        out: list[DataEdge] = []
        while self._heap and (limit is None or len(out) < limit):
            key, si, ev = self._heap[0]
            forced = len(self._heap) > self.reorder_capacity
            if not forced and (wm is None or ev.ts > wm):
                break
            heapq.heappop(self._heap)
            if forced and (wm is None or ev.ts > wm):
                self.n_forced += 1
            self.emit_floor = ev.ts if self.emit_floor is None \
                else max(self.emit_floor, ev.ts)
            self.adapters[si].ack(ev.seq)
            self.n_emitted += 1
            self.callbacks.emit("event", ev.edge)
            out.append(ev.edge)
        return out

    def drain(self, max_per_source: int = 64) -> list[DataEdge]:
        """Pump + take everything ready (offline convenience: loop this
        until ``exhausted`` to consume finite sources end-to-end)."""
        self.pump(max_per_source)
        return self.take_ready()

    # ------------------------------------------------------------------ #
    def stats(self) -> IngestStats:
        wm = self.watermark()
        highs = [a.high for a in self.adapters if a.high is not None]
        return IngestStats(
            n_sources=len(self.adapters),
            n_failed_sources=sum(
                1 for a in self.adapters if a.state == FAILED),
            n_emitted=self.n_emitted,
            n_late_dropped=self.n_late_dropped,
            n_dropped_forced_gap=self.n_dropped_forced_gap,
            n_duplicates=sum(a.n_duplicates for a in self.adapters),
            n_reconnects=sum(a.n_reconnects for a in self.adapters),
            n_retries=sum(a.n_retries for a in self.adapters),
            n_forced=self.n_forced,
            n_stalled_rounds=self.n_stalled_rounds,
            buffered=len(self._heap),
            watermark=wm,
            # how far the freshest data runs ahead of the watermark
            # (reorder/lateness slack held back by the slowest source)
            watermark_lag=(max(highs) - wm)
            if highs and wm is not None else 0,
            # how far forced evictions pushed releases past the
            # watermark (capacity pressure; 0 in healthy operation)
            window_staleness=max(0, self.emit_floor - wm)
            if wm is not None and self.emit_floor is not None else 0,
            emit_floor=self.emit_floor,
            by_source={a.name: {
                "state": a.state, "n_events": a.n_events,
                "n_duplicates": a.n_duplicates,
                "n_reconnects": a.n_reconnects, "cursor": a.acked.floor,
            } for a in self.adapters},
        )

    def publish_obs(self, obs) -> None:
        """Mirror the frontier's counters/gauges into a
        ``repro_torch.obs.MetricsRegistry`` under ``ingest.*``.

        Called once per serve tick by ``serve_frontier`` when the
        service carries a registry.  Reads plain int attributes only
        (no ``IngestStats`` construction); counters use ``set_total``
        so a frontier resumed from a checkpoint (which restores its own
        counters from the same manifest the registry restores from)
        never double-counts.
        """
        obs.counter("ingest.n_emitted").set_total(self.n_emitted)
        obs.counter("ingest.n_late_dropped").set_total(self.n_late_dropped)
        obs.counter("ingest.n_dropped_forced_gap").set_total(
            self.n_dropped_forced_gap)
        obs.counter("ingest.n_forced").set_total(self.n_forced)
        obs.counter("ingest.n_duplicates").set_total(
            sum(a.n_duplicates for a in self.adapters))
        obs.counter("ingest.n_reconnects").set_total(
            sum(a.n_reconnects for a in self.adapters))
        wm = self._wm_floor
        if wm is not None:
            obs.gauge("ingest.watermark").set(wm)
            highs = [a.high for a in self.adapters if a.high is not None]
            obs.gauge("ingest.watermark_lag").set(
                max(highs) - wm if highs else 0)
            if self.emit_floor is not None:
                obs.gauge("ingest.window_staleness").set(
                    max(0, self.emit_floor - wm))
        obs.gauge("ingest.buffered").set(len(self._heap))

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #
    def to_manifest(self) -> dict:
        """JSON-serializable resume state: per-source ack cursors + the
        emit floor + drop accounting.  Reflects exactly what has been
        handed DOWNSTREAM (emitted or counted-dropped) — events still in
        the reorder buffer are deliberately not covered, so a restore
        replays them from their sources."""
        return {
            "sources": [
                {"name": a.name, **a.acked.to_manifest()}
                for a in self.adapters
            ],
            "emit_floor": self.emit_floor,
            # the event-time clock rides in the checkpoint so a restored
            # frontier (and the engines it feeds) can never regress below
            # the released floor — no re-expiry, no resurrection
            "watermark": self.watermark(),
            "counters": {
                "n_emitted": int(self.n_emitted),
                "n_late_dropped": int(self.n_late_dropped),
                "n_dropped_forced_gap": int(self.n_dropped_forced_gap),
                "n_forced": int(self.n_forced),
            },
        }

    @classmethod
    def resume(cls, manifest: dict, sources: Iterable[Source],
               **kwargs) -> "IngestFrontier":
        """Rebuild a frontier from a checkpoint manifest + fresh source
        transports: each source reconnects at its ack cursor, replayed
        already-consumed deliveries are suppressed by the restored
        trackers, and the emit floor / drop counters continue — the
        exactly-once resume path (tested differentially)."""
        return cls(sources, _resume=manifest, **kwargs)
