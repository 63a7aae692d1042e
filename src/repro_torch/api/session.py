"""``StreamSession``: the typed public facade over the serving stack.

One session = one edge stream + many standing patterns.  The full
lifecycle is first-class::

    sess = StreamSession(ckpt_dir="/ckpts")
    sub = sess.register(pattern)            # -> Subscription handle
    sess.serve(events, ckpt_every=50)       # production loop
    for m in sub.drain():                   # typed Match records
        ...
    # crash?  restart:
    sess = StreamSession.restore("/ckpts")  # same qids, same vocab
    sess.serve(events[sess.resume_offset:])

Everything below the facade is ``repro_torch.runtime.service.
ContinuousSearchService`` — the session adds the parts the engine room
deliberately does not know about: the pattern DSL and canonicalizing
planner (isomorphic tenant patterns share one compiled slot tick), the
label vocabulary (string tokens on both the pattern and event side),
match translation back into the pattern's vertex/edge names, and
admission control off the engine's overflow counters (a structure whose
slot tables have already overflowed stops admitting new tenants instead
of silently dropping their partial matches).

With ``share_prefixes=True`` the engine additionally CSEs TC-subquery
prefixes across tenants (``repro_torch.core.share``): tenants whose canonical
patterns share a prefix alias ONE set of device tables for it, advanced
once per tick.  ``Subscription.shared_prefix`` reports the dedup
(externalized depth, co-tenant count), and ``ServeInfo.
n_shared_prefix_ticks`` counts the per-tick shared-table advances.

Checkpoints written by a session carry the session's own state (vocab +
per-subscription pattern plans) inside the service manifest, so
``StreamSession.restore`` rebuilds the full typed surface — original
qids, same token ids, same match vocabularies.  Match callbacks are the
one thing that cannot persist; re-attach them on the restored handles.

The port of ``repro.api.session``.  A session runs on the card
(``device=None`` means CUDA) unless the caller passes ``device="cpu"``.
``mesh=`` (an int replica count, or a dict of ``ShardedSearchService``
knobs) serves through the replica-sharded service
(``repro_torch.runtime.mesh``); its replicas sit on ``devices=`` (one
device per replica, repeats allowed), or all on ``device`` when that is
given, or on every visible CUDA device; ``group=`` (a ``torch.
distributed`` process group) splits the replicas over its ranks, every
rank running the session alike.  ``serve_frontier`` takes one
keyword the reference's session does not pass through: ``pump_size``,
the service's deliveries per source per round (the reference's session
always uses the service's default of 64), so that a session can fill a
wide tick from its sources.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np

from repro_torch.api.events import (
    EventBuffer,
    LabelVocab,
    Match,
    as_source,
    to_data_edge,
)
from repro_torch.api.pattern import Pattern
from repro_torch.api.planner import PatternPlan, compile_pattern
from repro_torch.checkpoint import CheckpointError
from repro_torch.core.query import QueryGraph
from repro_torch.core.registry import plan_signature
from repro_torch.obs import MetricsRegistry, to_prometheus
from repro_torch.runtime.service import ContinuousSearchService
from repro_torch.runtime.straggler import TickCoalescer

ACTIVE = "active"
DEGRADED = "degraded"      # overflow observed: matches may be incomplete
CLOSED = "closed"


class AdmissionError(RuntimeError):
    """Registration refused: the pattern's structural group is under
    capacity pressure (its slot tables have overflowed).  Serving a new
    tenant there would silently drop partial matches; pass
    ``force=True`` to register anyway, or grow the session capacities.
    """


class SessionStatus(NamedTuple):
    """Snapshot of a session's serving health (``StreamSession.status``)."""

    n_subscriptions: int
    n_edges_ingested: int
    n_ticks: int
    n_compiles: int
    degraded: tuple      # qids whose slot tables have overflowed
    # ingest-frontier health (None until a frontier serves this session)
    ingest: object = None          # IngestStats of the bound frontier
    n_late_dropped: int = 0        # frontier late drops (cumulative)
    n_duplicates: int = 0          # suppressed duplicate deliveries
    n_reconnects: int = 0          # source reconnects survived
    n_dropped_forced_gap: int = 0  # capacity-pressure drops (reorder
                                   # buffer forced past the watermark)
    watermark: int | None = None   # the frontier's event-time clock
    health: str = ACTIVE           # DEGRADED when overflow OR the
                                   # late-drop rate crosses the threshold
                                   # OR forced-gap drops occurred
                                   # (capacity pressure, never silent)


class Subscription:
    """Handle for one registered pattern: matches out, lifecycle in.

    Matches arrive either through ``on_match(match)`` (when set) or an
    internal queue read by ``drain()`` — the queue is bounded at
    ``MAX_PENDING`` (oldest dropped first, counted in ``n_dropped``), so
    a consumer that never drains cannot grow memory without bound.
    ``matches()`` reads the current window content.  All records are
    ``repro_torch.api.events.Match`` — bindings keyed by the pattern's own
    vertex/edge names.
    """

    #: queue-mode backlog bound: past this, oldest un-drained matches
    #: are dropped (and counted) rather than growing memory forever
    MAX_PENDING = 1 << 16

    def __init__(self, session: "StreamSession", qid: int, plan: PatternPlan,
                 on_match=None):
        self.session = session
        self.qid = qid
        self.plan = plan
        self.on_match = on_match
        self._pending: deque[Match] = deque(maxlen=self.MAX_PENDING)
        self.n_delivered = 0
        self.n_dropped = 0
        self._closed = False
        # column index of each authored vertex/edge in the engine's
        # final match layout (through the canonical relabeling)
        eplan = session.service.registry.get(qid).plan
        vslot = {v: s for s, v in enumerate(eplan.final_vertex_layout)}
        epos = {e: s for s, e in enumerate(eplan.final_edge_layout)}
        self._vcols = tuple(vslot[c] for c in plan.vertex_map)
        self._ecols = tuple(epos[c] for c in plan.edge_map)

    # ------------------------------------------------------------------ #
    @property
    def name(self) -> str | None:
        return self.plan.name

    @property
    def query(self) -> QueryGraph:
        """The canonical compiled query (engine label space)."""
        return self.plan.query

    @property
    def window(self) -> int:
        return self.plan.window

    @property
    def n_overflow(self) -> int:
        """Cumulative engine-side overflow for this tenant's tables
        (including, under prefix sharing, its shared prefix chain)."""
        if self._closed:
            return 0
        return self.session.service.tenant_overflow(self.qid)

    @property
    def shared_prefix(self):
        """``SharedPrefixInfo`` (depth / co-tenants / epoch) when the
        session shares TC-subquery prefixes across tenants
        (``share_prefixes=True``), else None."""
        if self._closed:
            return None
        return self.session.service.shared_prefix(self.qid)

    @property
    def status(self) -> str:
        if self._closed:
            return CLOSED
        return DEGRADED if self.n_overflow else ACTIVE

    # ------------------------------------------------------------------ #
    def _match_from_row(self, b_row, t_row) -> Match:
        return Match(
            vertices=tuple(
                (n, int(b_row[c]))
                for n, c in zip(self.plan.vertex_names, self._vcols)),
            edges=tuple(
                (n, int(t_row[c]))
                for n, c in zip(self.plan.edge_names, self._ecols)),
        )

    def _match_from_key(self, key) -> Match:
        bind: dict[int, int] = {}
        times: dict[int, int] = {}
        for eid, (src, dst, ts) in key:
            u, v = self.plan.query.edges[eid]
            bind[u], bind[v], times[eid] = src, dst, ts
        return Match(
            vertices=tuple(
                (n, bind[c])
                for n, c in zip(self.plan.vertex_names, self.plan.vertex_map)),
            edges=tuple(
                (n, times[c])
                for n, c in zip(self.plan.edge_names, self.plan.edge_map)),
        )

    def _deliver(self, match: Match):
        self.n_delivered += 1
        if self.on_match is not None:
            self.on_match(match)
            return
        if len(self._pending) == self.MAX_PENDING:
            self.n_dropped += 1          # deque(maxlen) evicts the oldest
        self._pending.append(match)

    def _deliver_rows(self, bindings, ets):
        """Deliver engine match rows (the one translation/delivery path
        shared by ``ingest``, ``serve``, and ``StreamServer``)."""
        for b_row, t_row in zip(bindings, ets):
            self._deliver(self._match_from_row(b_row, t_row))
        return len(bindings)

    # ------------------------------------------------------------------ #
    def drain(self) -> list[Match]:
        """New matches reported since the last ``drain`` (queue mode —
        empty when an ``on_match`` callback is consuming them)."""
        out = list(self._pending)
        self._pending.clear()
        return out

    def matches(self) -> list[Match]:
        """All complete matches currently inside the window."""
        keys = self.session.service.matches(self.qid)
        return sorted((self._match_from_key(k) for k in keys))

    def close(self):
        """Unregister the pattern and drop its partial-match state."""
        self.session._close(self)

    def __repr__(self) -> str:
        return (f"Subscription(qid={self.qid}, name={self.name!r}, "
                f"status={self.status if not self._closed else CLOSED!r})")


class StreamSession:
    """Declarative serving session over one continuous edge stream."""

    def __init__(
        self,
        slots_per_group: int = 4,
        level_capacity: int = 2048,
        l0_capacity: int = 2048,
        max_new: int = 512,
        backend: str | None = None,
        max_out: int | None = None,
        ckpt_dir: str | None = None,
        keep_checkpoints: int = 8,
        tick_cache=None,
        share_prefixes: bool = False,
        late_drop_threshold: float = 0.01,
        mesh: dict | int | None = None,
        obs: MetricsRegistry | None = None,
        tracer=None,
        *,
        device=None,
        devices=None,
        group=None,
        _service: ContinuousSearchService | None = None,
    ):
        if _service is None:
            common = dict(
                level_capacity=level_capacity,
                l0_capacity=l0_capacity,
                max_new=max_new,
                backend=backend,
                extract_matches=True,     # the facade's whole point
                max_out=max_out,
                ckpt_dir=ckpt_dir,
                keep_checkpoints=keep_checkpoints,
                tick_cache=tick_cache,
                enable_sharing=share_prefixes,
                device=device,
            )
            if mesh is not None:
                # replica-sharded serving: ``mesh`` is the replica count
                # or a dict of ShardedSearchService knobs (n_replicas,
                # slots_per_replica, placement); the slot-group width is
                # then n_replicas * slots_per_replica, so
                # ``slots_per_group`` is ignored on this path
                from repro_torch.runtime.mesh import ShardedSearchService
                mesh_kw = ({"n_replicas": mesh} if isinstance(mesh, int)
                           else dict(mesh))
                _service = ShardedSearchService(**mesh_kw, devices=devices,
                                                group=group, **common)
            else:
                if devices is not None or group is not None:
                    raise ValueError("devices= and group= place the "
                                     "replicas of a mesh session; pass "
                                     "mesh= too")
                _service = ContinuousSearchService(
                    slots_per_group=slots_per_group, **common)
        self.service = _service
        # the session ALWAYS carries a metrics registry: status()/health
        # read the registry's ``ingest.*`` counters instead of a live
        # frontier's private ones, so drop-driven DEGRADED attribution
        # survives checkpoint/restore (the registry reloads its counter
        # history from the manifest) and both health paths — drop-rate
        # and forced-gap — share one source of truth.
        if self.service.obs is None:
            self.service.obs = obs if obs is not None else MetricsRegistry()
            self.service._register_obs_gauges()
        self.obs = self.service.obs
        if tracer is not None and self.service.tracer is None:
            self.service.tracer = tracer
        self.vocab = LabelVocab()
        self._subs: dict[int, Subscription] = {}
        self._coalescer: TickCoalescer | None = None
        # session health turns DEGRADED when the frontier's late-drop
        # rate (drops / delivered) crosses this; 0 disables the margin
        # (any drop degrades)
        self.late_drop_threshold = late_drop_threshold
        self._frontier = None
        # session state rides inside every service checkpoint manifest
        self.service.manifest_extra = self._api_manifest

    # ------------------------------------------------------------------ #
    def _api_manifest(self) -> dict:
        return {
            "api": {
                "vocab": self.vocab.to_json(),
                "subscriptions": {
                    str(qid): sub.plan.to_json()
                    for qid, sub in self._subs.items()
                },
            }
        }

    # ------------------------------------------------------------------ #
    def register(self, pattern: Pattern | PatternPlan, on_match=None,
                 force: bool = False) -> Subscription:
        """Register a standing pattern; returns its ``Subscription``.

        The pattern is canonicalized first, so any authoring of an
        already-served structure arms a free slot in an existing group —
        a pure device-data write, no tick build.  Admission
        control: if that structure's live slot tables have already
        overflowed, registration raises ``AdmissionError`` (the new
        tenant would silently lose matches) unless ``force=True``.
        """
        plan = (pattern if isinstance(pattern, PatternPlan)
                else compile_pattern(pattern, self.vocab))
        eplan = self.service.registry.compile(plan.query, plan.window)
        if not force:
            pressure = self.service.overflow_pressure(plan_signature(eplan))
            if pressure:
                raise AdmissionError(
                    f"structure of pattern {plan.name!r} is under capacity "
                    f"pressure ({pressure} overflowed appends); grow "
                    "level_capacity/max_new or pass force=True")
        qid = self.service.register(plan.query, plan.window, plan=eplan)
        sub = Subscription(self, qid, plan, on_match=on_match)
        self._subs[qid] = sub
        return sub

    def register_query(self, query: QueryGraph, window: int, plan=None,
                       name: str | None = None) -> Subscription:
        """Escape hatch: register a raw ``QueryGraph`` (or an exact
        pre-compiled ``ExecutionPlan``) under synthesized vertex/edge
        names.  NOT canonicalized — an exact plan must be served as
        given, so cross-authoring dedup does not apply here.
        """
        qid = self.service.register(query, window, plan=plan)
        sub = Subscription(self, qid, PatternPlan.identity(query, window,
                                                           name=name))
        self._subs[qid] = sub
        return sub

    def _close(self, sub: Subscription):
        if sub._closed:
            return
        self.service.unregister(sub.qid)
        self._subs.pop(sub.qid, None)
        sub._closed = True

    # ------------------------------------------------------------------ #
    def _dispatch(self, results) -> int:
        delivered = 0
        for qid, r in results.items():
            sub = self._subs.get(qid)
            if sub is None:
                continue
            valid = r.match_valid.cpu().numpy()
            if valid.any():
                delivered += sub._deliver_rows(
                    r.match_bindings.cpu().numpy()[valid],
                    r.match_ets.cpu().numpy()[valid])
        return delivered

    def ingest(self, events, batch_size: int = 64) -> int:
        """Deterministic fixed-chunk ingest (testing / replay path).

        ``events`` may be ``Event`` records (vocab-translated) or raw
        ``DataEdge``s (already in engine label space).  Batches are
        padded to power-of-two widths by ``EventBuffer``.  Returns the
        number of matches delivered; read them via ``Subscription.
        drain()`` / callbacks.  For production serving (adaptive
        coalescing, checkpoint cadence) use ``serve``.
        """
        buf = EventBuffer(self.vocab, batch_size)
        batches = [b for ev in events if (b := buf.push(ev)) is not None]
        tail = buf.flush()
        if tail is not None:
            batches.append(tail)
        delivered = 0
        for b in batches:
            delivered += self._dispatch(self.service.ingest(b))
        return delivered

    def serve(self, events, ckpt_every: int = 0, batch_size: int = 64,
              min_batch: int | None = None, max_batch: int | None = None,
              target_latency_ms: float = 50.0, on_tick=None,
              final_checkpoint: bool = True) -> dict:
        """The production loop: adaptive tick coalescing, periodic async
        checkpoints, backpressure off the slowest group.

        Delegates to ``ContinuousSearchService.serve_stream``; the AIMD
        coalescer state persists across ``serve`` calls (batch-size
        arguments seed only the first).  Matches route to each
        subscription (queue or callback); returns ``{subscription:
        n_new_matches}`` for the served span.  ``on_tick(ServeInfo)``
        surfaces per-tick latency and overflow counts for external
        monitoring: its ``latency_ms`` times dispatch and the barrier,
        not the batch build nor delivery.  With a tracer, the conversion
        of ``events`` is the span ``api.convert``, under the id of the
        tick it feeds.
        """
        tr = self.service.tracer
        if tr is not None:
            t_convert = time.perf_counter()
        edges = [to_data_edge(e, self.vocab) for e in events]
        if tr is not None:
            tr.record("api.convert",
                      (time.perf_counter() - t_convert) * 1e3,
                      start=t_convert, tick=tr.tick + 1,
                      n_events=len(edges))

        def _on_match(qid, bindings, ets):
            sub = self._subs.get(qid)
            if sub is not None:
                sub._deliver_rows(bindings, ets)

        if self._coalescer is None:
            self._coalescer = TickCoalescer.seeded(
                batch_size, min_batch, max_batch, target_latency_ms)
        totals = self.service.serve_stream(
            edges, on_match=_on_match, on_tick=on_tick,
            ckpt_every=ckpt_every, coalescer=self._coalescer,
            final_checkpoint=final_checkpoint)
        return {self._subs[qid]: n for qid, n in totals.items()
                if qid in self._subs}

    # ingestion frontier: sources in, watermark-ordered ticks out
    # ------------------------------------------------------------------ #
    def sources(self, named_events: dict, resume: dict | None = None,
                **frontier_kw):
        """Build an ``IngestFrontier`` over named event streams.

        ``named_events`` maps source name -> a list of typed ``Event``s
        / raw ``DataEdge``s (vocab-translated here), OR an already-built
        ``repro_torch.stream.ingest`` ``Source`` (e.g. a chaos-wrapped one),
        passed through as-is.  ``resume`` is a restored ingest manifest
        (``session.restored_ingest``): sources reconnect at their ack
        cursors and replayed deliveries are suppressed — the
        exactly-once mid-stream resume.  Keyword args flow to
        ``IngestFrontier`` (``allowed_lateness``, ``retry``, ...).

        ``allowed_lateness`` is an END-TO-END event-time contract, not
        just a buffer knob: the frontier's watermark (min over live
        sources of max event time, minus the lateness) gates release
        AND drives every engine's window clock during
        ``serve_frontier``, so an event within the allowed lateness is
        guaranteed to find its still-unexpired join partners, and an
        event beyond it is rejected-and-counted, never half-joined.
        Larger lateness = more completeness, staler windows
        (``SessionStatus.ingest.window_staleness`` gauges the trade).
        """
        from repro_torch.stream.ingest import IngestFrontier, Source
        srcs = [ev if isinstance(ev, Source) else
                as_source(name, ev, self.vocab)
                for name, ev in named_events.items()]
        if resume is not None:
            return IngestFrontier.resume(resume, srcs, **frontier_kw)
        return IngestFrontier(srcs, **frontier_kw)

    def serve_frontier(self, frontier, ckpt_every: int = 0,
                       batch_size: int = 64, min_batch: int | None = None,
                       max_batch: int | None = None,
                       target_latency_ms: float = 50.0, on_tick=None,
                       final_checkpoint: bool = True,
                       max_idle_rounds: int | None = None, *,
                       pump_size: int = 64) -> dict:
        """Serve from an ingestion frontier: retry/dedup per source,
        deterministic k-way event-time merge, watermark-driven ticking.

        Same contract as ``serve`` otherwise: matches route to each
        subscription, the AIMD coalescer persists across calls, and
        checkpoints written during the loop embed the frontier's resume
        cursors AND its event-time watermark (see ``restored_ingest``) —
        a restored session resumes the same window clock, so nothing
        re-expires or resurrects.  Windows are EVENT-time here: the
        frontier's watermark drives engine admission/expiry every tick
        (``serve``'s in-process path keeps the classic max-ts clock).
        ``status()`` reports the frontier's late-drop / forced-gap /
        duplicate / reconnect accounting, turning DEGRADED when the
        late-drop rate crosses ``late_drop_threshold`` or any
        capacity-pressure (forced-gap) drop occurred — no event
        vanishes silently.  ``pump_size`` is the service's deliveries
        per source per round (``ContinuousSearchService.serve_frontier``).
        """
        self._frontier = frontier

        def _on_match(qid, bindings, ets):
            sub = self._subs.get(qid)
            if sub is not None:
                sub._deliver_rows(bindings, ets)

        if self._coalescer is None:
            self._coalescer = TickCoalescer.seeded(
                batch_size, min_batch, max_batch, target_latency_ms)
        totals = self.service.serve_frontier(
            frontier, on_match=_on_match, on_tick=on_tick,
            ckpt_every=ckpt_every, coalescer=self._coalescer,
            final_checkpoint=final_checkpoint,
            max_idle_rounds=max_idle_rounds, pump_size=pump_size)
        return {self._subs[qid]: n for qid, n in totals.items()
                if qid in self._subs}

    @property
    def restored_ingest(self) -> dict | None:
        """Ingest resume manifest from the checkpoint this session was
        restored from (None on a fresh session): pass to ``sources(...,
        resume=...)`` to pick the stream back up exactly-once."""
        return self.service.restored_ingest

    # ------------------------------------------------------------------ #
    def subscriptions(self) -> list[Subscription]:
        return [self._subs[qid] for qid in sorted(self._subs)]

    def status(self) -> SessionStatus:
        svc = self.service
        degraded = tuple(qid for qid, s in sorted(self._subs.items())
                         if s.n_overflow > 0)
        # ONE source of truth for ingest health: the obs registry's
        # ``ingest.*`` counters.  A live frontier refreshes them first;
        # after a restore (no frontier bound yet) the restored counter
        # history still reports, so health never silently resets to
        # ACTIVE while the stream's drops persist.
        ing = None
        if self._frontier is not None:
            self._frontier.publish_obs(self.obs)
            ing = self._frontier.stats()
        n_late = self.obs.counter("ingest.n_late_dropped").value
        n_forced_gap = self.obs.counter("ingest.n_dropped_forced_gap").value
        n_emitted = self.obs.counter("ingest.n_emitted").value
        drop_rate = n_late / max(1, n_late + n_emitted)
        # forced-gap drops are capacity pressure (the reorder buffer
        # force-evicted past the watermark): any amount degrades health —
        # unlike user lateness, no threshold makes it acceptable
        health = DEGRADED if degraded \
            or drop_rate > self.late_drop_threshold \
            or n_forced_gap > 0 else ACTIVE
        return SessionStatus(
            n_subscriptions=len(self._subs),
            n_edges_ingested=svc.n_edges_ingested,
            n_ticks=svc.n_ticks,
            n_compiles=svc.n_compiles,
            degraded=degraded,
            ingest=ing,
            n_late_dropped=n_late,
            n_duplicates=int(self.obs.counter("ingest.n_duplicates").value),
            n_reconnects=int(self.obs.counter("ingest.n_reconnects").value),
            n_dropped_forced_gap=n_forced_gap,
            watermark=None if ing is None else ing.watermark,
            health=health,
        )

    def metrics(self) -> dict:
        """Flat snapshot of the session's obs registry (counters,
        gauges incl. collect-time callbacks, histogram percentiles)."""
        return self.obs.snapshot()

    def prometheus(self) -> str:
        """The session's metrics in Prometheus text exposition format
        (serve it from any HTTP endpoint you like)."""
        return to_prometheus(self.obs)

    @property
    def resume_offset(self) -> int:
        """Edges already consumed (slice the replay stream here)."""
        return self.service.n_edges_ingested

    # ------------------------------------------------------------------ #
    def checkpoint(self):
        """Snapshot the full session (engine state + vocab + patterns)
        asynchronously; returns the writer future."""
        return self.service.checkpoint()

    def close(self):
        """Flush pending checkpoint writes (subscriptions stay live —
        close them individually to unregister)."""
        if self.service.ckpt is not None:
            self.service.ckpt.wait()

    @classmethod
    def adopt(cls, service: ContinuousSearchService) -> "StreamSession":
        """Wrap an existing (possibly restored) service in a typed
        session.  Checkpointed api state (vocab + pattern plans) is
        rebuilt when present; tenants registered below the api layer get
        synthesized identity name maps (``v0..``/``e0..``).
        """
        extra = (service.manifest_extra
                 if isinstance(service.manifest_extra, dict) else {})
        api = extra.get("api", {})
        # cls() re-binds service.manifest_extra to the live session state,
        # replacing the frozen dict restored from the manifest
        sess = cls(_service=service)
        if api:
            sess.vocab = LabelVocab.from_json(api["vocab"])
        plans = {int(q): PatternPlan.from_json(pj)
                 for q, pj in api.get("subscriptions", {}).items()}
        for qid in service.registry.qids():
            plan = plans.get(qid)
            if plan is None:
                rq = service.registry.get(qid)
                plan = PatternPlan.identity(rq.query, rq.window)
            sess._subs[qid] = Subscription(sess, qid, plan)
        return sess

    @classmethod
    def restore(cls, ckpt_dir: str, step: int | None = None,
                tick_cache=None, backend: str | None = None,
                obs: MetricsRegistry | None = None, *,
                device=None, devices=None,
                group=None) -> "StreamSession":
        """Rebuild a full session from the newest usable checkpoint:
        original qids, same label vocabulary, same pattern plans, zero
        recompiles for structures this process has already served.
        Match callbacks cannot persist — re-attach them on the restored
        ``Subscription`` handles.  The obs registry's counter history
        (drops, ticks, checkpoint latencies) reloads from the manifest,
        so ``status()`` health attribution survives the restore.  The
        state lands on ``device`` (``None``: the card).  A checkpoint of
        a mesh session comes back as a mesh session on the same number
        of replicas, placed on ``devices`` (or all on ``device``), over
        ``group`` when it is given (every rank calls this).
        """
        obs = obs if obs is not None else MetricsRegistry()
        if devices is not None or group is not None:
            from repro_torch.runtime.mesh import ShardedSearchService
            svc = ShardedSearchService.restore(
                ckpt_dir, step=step, tick_cache=tick_cache, backend=backend,
                extract_matches=True, obs=obs, devices=devices,
                device=device, group=group)
        else:
            svc = ContinuousSearchService.restore(
                ckpt_dir, step=step, tick_cache=tick_cache, backend=backend,
                extract_matches=True, obs=obs, device=device)
        extra = svc.manifest_extra if isinstance(svc.manifest_extra, dict) \
            else {}
        if extra.get("api") is None:
            raise CheckpointError(
                f"checkpoint under {ckpt_dir!r} was not written by a "
                "StreamSession (no api state in the manifest); restore it "
                "as a ContinuousSearchService instead")
        return cls.adopt(svc)

    def __repr__(self) -> str:
        return (f"StreamSession({len(self._subs)} subscriptions, "
                f"{self.service.n_edges_ingested} edges, "
                f"{self.service.n_ticks} ticks)")
