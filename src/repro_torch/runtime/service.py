"""Continuous-search service: the multi-tenant serving engine.

The port of ``repro.runtime.service.ContinuousSearchService``.  Standing
queries arrive and leave while the edge stream flows; the service keeps
the build count fixed by bucketing queries into padded slot groups keyed
by structural signature, and drives every group's tick once per batch.

* ``register(query, window)`` compiles the query's plan (host-side),
  looks up its structural signature and arms a free slot in a group of
  that structure — a data write on the card, no rebuild.  Built ticks
  live in a process-wide ``SlotTickCache``; ``n_compiles`` counts the
  builds this service caused.
* ``unregister(qid)`` disarms the slot (data only).
* ``ingest(batch)`` advances every group once and returns
  ``{qid: TickResult}``.
* ``serve_stream(edges, ...)`` is the production loop over a DataEdge
  list: a ``TickCoalescer`` adapts the chunk size to the measured
  per-tick barrier latency, chunks are padded to power-of-two shapes,
  matches stream out through ``on_match(qid, bindings, ets)``.

The service runs on the card (``device=None`` means CUDA) unless the
caller passes ``device="cpu"``; its joins default to the CUDA kernel on
the card and to the plain version on the CPU (``JoinBackend``).

Later slices of the port: checkpoint/restore, prefix sharing
(``enable_sharing``), the ingest frontier (``serve_frontier``) and the
observability hooks (``obs``/``tracer``); the constructor does not take
them yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import join as J
from repro_torch.core.engine import TickResult, current_matches
from repro_torch.core.multi import (
    GLOBAL_SLOT_TICK_CACHE,
    SlotState,
    SlotTickCache,
    clear_slot,
    init_slot_state,
    read_slot,
    write_slot,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.registry import QueryRegistry
from repro_torch.core.state import (
    EdgeBatch,
    EngineState,
    init_state,
    make_batch,
    map_state,
    resolve_device,
)
from repro_torch.runtime.straggler import TickCoalescer, quantize_pow2
from repro_torch.stream.generator import to_batches


class ServeInfo(NamedTuple):
    """Per-tick record passed to ``serve_stream``'s ``on_tick`` callback."""

    tick: int               # cumulative tick count
    n_edges_ingested: int   # cumulative edges consumed after this tick
    chunk: int              # edges consumed by this tick
    latency_ms: float       # barrier latency of this tick (all groups)
    n_overflow: int = 0     # dropped appends this tick, summed over qids


@dataclass(eq=False)       # identity semantics: fields hold device tensors
class _Group:
    """One slot group: built tick + device state + slot ownership."""

    gid: int
    template: ExecutionPlan
    tick: object                      # slot tick (SlotTickCache-shared)
    sstate: SlotState
    empty: EngineState                # cached init_state(template) for churn
    qids: list = field(default_factory=list)   # qid | None per slot

    def free_slot(self) -> int | None:
        for k, q in enumerate(self.qids):
            if q is None:
                return k
        return None

    @property
    def idle(self) -> bool:
        return all(q is None for q in self.qids)


class ContinuousSearchService:
    """Multi-tenant continuous subgraph search over one edge stream."""

    def __init__(
        self,
        slots_per_group: int = 4,
        level_capacity: int = 2048,
        l0_capacity: int = 2048,
        max_new: int = 512,
        backend: str | None = None,
        extract_matches: bool = True,
        max_out: int | None = None,
        tick_cache: SlotTickCache | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.backend = J.resolve_backend(backend, self.device)
        self.slots_per_group = slots_per_group
        self.extract_matches = extract_matches
        self.max_out = max_out
        self.tick_cache = (GLOBAL_SLOT_TICK_CACHE if tick_cache is None
                           else tick_cache)
        self.registry = QueryRegistry(
            level_capacity=level_capacity, l0_capacity=l0_capacity,
            max_new=max_new)
        self._groups: dict[tuple, list[_Group]] = {}
        self._location: dict[int, tuple[_Group, int]] = {}
        self._next_gid = 0
        self.n_compiles = 0          # build_slot_tick cache misses (this service)
        self.n_edges_ingested = 0
        self.n_ticks = 0

    # ------------------------------------------------------------------ #
    @property
    def n_active(self) -> int:
        return len(self._location)

    def _iter_groups(self) -> list[_Group]:
        """All groups in stable gid order (serving order)."""
        return sorted((g for gs in self._groups.values() for g in gs),
                      key=lambda g: g.gid)

    def _new_group(self, template: ExecutionPlan) -> _Group:
        before = self.tick_cache.n_builds
        tick = self.tick_cache.get(
            template, backend=self.backend,
            extract_matches=self.extract_matches, max_out=self.max_out)
        self.n_compiles += self.tick_cache.n_builds - before
        g = _Group(
            gid=self._next_gid,
            template=template,
            tick=tick,
            sstate=init_slot_state(template, self.slots_per_group,
                                   self.device),
            empty=init_state(template, self.device),
            qids=[None] * self.slots_per_group,
        )
        self._next_gid += 1
        return g

    def _place(self, groups: list, plan: ExecutionPlan) -> tuple[_Group, int]:
        """Pick ``(group, slot)`` for a new tenant of this structure,
        allocating a fresh group when none has a free slot."""
        for g in groups:
            k = g.free_slot()
            if k is not None:
                return g, k
        g = self._new_group(plan)
        groups.append(g)
        return g, 0

    # ------------------------------------------------------------------ #
    def register(self, query: QueryGraph, window: int,
                 plan: ExecutionPlan | None = None) -> int:
        """Add a standing query; returns its qid.

        A pure data write when a group with the same structural
        signature has a free slot; an overflowing (or never-seen)
        structure allocates one new group, whose tick comes from the
        ``SlotTickCache`` — only a structure new to the process builds.
        """
        qid = self.registry.register(query, window, plan=plan)
        rq = self.registry.get(qid)
        gkey = rq.signature
        try:
            groups = self._groups.setdefault(gkey, [])
            group, k = self._place(groups, rq.plan)
            write_slot(group.sstate, group.template, k, rq.plan,
                       empty=group.empty)
        except Exception:
            # no half-registered tenant
            self.registry.unregister(qid)
            if not self._groups.get(gkey):
                self._groups.pop(gkey, None)
            raise
        group.qids[k] = qid
        self._location[qid] = (group, k)
        return qid

    def unregister(self, qid: int) -> None:
        """Drop a standing query and its partial-match state (data-only).

        A group whose slots all become empty is released, except that
        one idle group per structural signature is kept warm.  Use
        ``drop_idle_groups()`` to reclaim the warm groups too.
        """
        group, k = self._location.pop(qid)
        clear_slot(group.sstate, group.template, k, empty=group.empty)
        group.qids[k] = None
        self.registry.unregister(qid)
        if group.idle:
            gkey = next(
                key for key, gs in self._groups.items() if group in gs)
            siblings = self._groups[gkey]
            if sum(1 for g in siblings if g.idle) > 1:
                siblings.remove(group)
                if not siblings:
                    del self._groups[gkey]

    def overflow_pressure(self, signature=None) -> int:
        """Cumulative dropped appends across active tenants — of one
        structural ``plan_signature``, or the whole service.  One device
        read per group; call at admission/status time, not per tick."""
        groups = (self._groups.get(signature, []) if signature is not None
                  else self._iter_groups())
        return sum(int(g.sstate.engines.stats.n_overflow.sum())
                   for g in groups if not g.idle)

    def drop_idle_groups(self) -> int:
        """Release all fully-empty slot groups; returns how many were
        dropped.  Built ticks stay cached."""
        dropped = 0
        for sig in list(self._groups):
            keep = [g for g in self._groups[sig] if not g.idle]
            dropped += len(self._groups[sig]) - len(keep)
            if keep:
                self._groups[sig] = keep
            else:
                del self._groups[sig]
        return dropped

    # ------------------------------------------------------------------ #
    def _batch(self, batch) -> EdgeBatch:
        if isinstance(batch, EdgeBatch):
            return batch
        return make_batch(**batch, device=self.device)

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ingest(self, batch, watermark=None) -> dict[int, TickResult]:
        """Advance all standing queries by one batch of stream edges.

        ``batch`` is an EdgeBatch or a dict of arrays (``to_batches``
        output).  Returns a per-qid TickResult (views of each group's
        stacked result).  ``watermark`` switches the engines to
        event-time admission/expiry; None keeps the max-ts clock.
        """
        batch = self._batch(batch)
        out: dict[int, TickResult] = {}
        for g in self._iter_groups():
            if g.idle:
                continue
            g.sstate, res = g.tick(g.sstate, batch, watermark)
            for k, qid in enumerate(g.qids):
                if qid is not None:
                    out[qid] = map_state(lambda x, k=k: x[k], res)
        self.n_ticks += 1
        self.n_edges_ingested += int(batch.valid.sum())
        return out

    # ------------------------------------------------------------------ #
    def serve_stream(
        self,
        edges: list,
        on_match=None,
        on_tick=None,
        batch_size: int = 64,
        min_batch: int | None = None,
        max_batch: int | None = None,
        target_latency_ms: float = 50.0,
        coalescer: TickCoalescer | None = None,
    ) -> dict[int, int]:
        """Drive the service over a DataEdge list (the production loop).

        A ``TickCoalescer`` adapts the chunk size to the measured tick
        latency, queue depth and overflow; chunks are padded to power-of-
        two shapes.  All groups are dispatched, then the loop meets ONE
        barrier per tick (``torch.cuda.synchronize`` on the card), so the
        measured latency is what every group experiences.
        ``on_match(qid, bindings, ets)`` fires for each tenant's new
        matches; ``on_tick(ServeInfo)`` after each tick.  Returns
        ``{qid: total new matches}`` over the served span.
        """
        if on_match is not None and not self.extract_matches:
            raise ValueError(
                "on_match requires a service with extract_matches=True")
        if coalescer is None:
            coalescer = TickCoalescer.seeded(
                batch_size, min_batch, max_batch, target_latency_ms)
        totals: dict[int, int] = {}
        i, n = 0, len(edges)
        while i < n:
            chunk = edges[i:i + coalescer.batch]
            queue_depth = n - (i + len(chunk))
            lat_ms, tick_overflow = self._tick_chunk(chunk, on_match, totals)
            coalescer.record(lat_ms, queue_depth, tick_overflow)
            i += len(chunk)
            if on_tick is not None:
                on_tick(ServeInfo(
                    tick=self.n_ticks,
                    n_edges_ingested=self.n_edges_ingested,
                    chunk=len(chunk),
                    latency_ms=lat_ms,
                    n_overflow=tick_overflow,
                ))
        return totals

    def _tick_chunk(self, chunk: list, on_match, totals: dict,
                    watermark=None) -> tuple[float, int]:
        """One production tick over ``chunk``: pow-2 padded batch, every
        group dispatched, ONE barrier, then one host copy of each group's
        result and match delivery.  Returns (barrier latency ms, tick
        overflow)."""
        active = [g for g in self._iter_groups() if not g.idle]
        batch = make_batch(**to_batches(chunk, quantize_pow2(len(chunk)))[0],
                           device=self.device)
        t0 = time.perf_counter()
        results = []
        for g in active:
            g.sstate, res = g.tick(g.sstate, batch, watermark)
            results.append((g, res))
        self._barrier()
        lat_ms = (time.perf_counter() - t0) * 1e3
        tick_overflow = 0
        for g, res in results:
            host = map_state(lambda x: x.cpu().numpy(), res)
            for k, qid in enumerate(g.qids):
                if qid is None:
                    continue
                n_new = int(host.n_new_matches[k])
                tick_overflow += int(host.n_overflow[k])
                totals[qid] = totals.get(qid, 0) + n_new
                if n_new and on_match is not None:
                    valid = host.match_valid[k]
                    on_match(qid, host.match_bindings[k][valid],
                             host.match_ets[k][valid])
        self.n_ticks += 1
        self.n_edges_ingested += len(chunk)
        return lat_ms, tick_overflow

    # ------------------------------------------------------------------ #
    def state(self, qid: int) -> EngineState:
        """This query's (unstacked) engine state."""
        group, k = self._location[qid]
        return read_slot(group.sstate, k)

    def matches(self, qid: int):
        """All complete matches currently in the query's window."""
        plan = self.registry.get(qid).plan
        return current_matches(plan, self.state(qid))

    def stats(self, qid: int):
        return self.state(qid).stats
