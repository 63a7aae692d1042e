"""Continuous-search service: the multi-tenant serving engine.

The port of ``repro.runtime.service.ContinuousSearchService``.  The
public way to use it is ``repro_torch.api`` — a ``StreamSession`` facade
(pattern DSL, canonicalizing planner, typed Event/Match records,
admission control) that drives this class underneath;
``repro_torch.launch.stream_serve.StreamServer`` is a one-tenant wrapper
over the same path.  Standing queries arrive and leave while the edge
stream flows; the service keeps the build count fixed by bucketing
queries into padded slot groups keyed by structural signature, and owns
the production loop: adaptive tick coalescing, periodic async
checkpoints, and restore.

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
  matches stream out through ``on_match(qid, bindings, ets)``, and every
  ``ckpt_every`` ticks the service state is checkpointed asynchronously.
* ``serve_frontier(frontier, ...)`` is the same loop fed by an
  ``IngestFrontier`` (``repro_torch.stream.ingest``: sources, retry,
  dedup, event-time merge): it ticks on watermark advance and hands the
  frontier's watermark to every engine as one int32 device scalar per
  tick (event-time admission and expiry); checkpoints embed the
  frontier's resume cursors, which ``restore`` surfaces as
  ``restored_ingest``.

Cross-tenant prefix sharing (``enable_sharing=True``,
``repro_torch.core.share``): each registration acquires a refcounted
chain of ``SharedPrefixForest`` nodes — one table per canonical prefix
signature and registration epoch — and the tenant's slot tick consumes
the leaf's view, running only its suffix joins.  The forest advances
ONCE per tick however many tenants alias a node; slot groups gain a
prefix dimension (group key = structural signature × prefix node), and
checkpoints hold the forest (tables, refcounts, signatures), so a
restored service resumes sharing with zero warm rebuilds.

Checkpoints (``ckpt_dir``): ``checkpoint()`` copies every group's
``SlotState`` and every forest node's state to host memory before it
returns and writes them with a JSON manifest of the registry (qid ->
query/window/decomposition, slot layout, templates, forest, counters,
obs history) on a writer thread, in the reference's file format and key
names.  ``ContinuousSearchService.restore(ckpt_dir)`` rebuilds the
service from the newest usable step — torn or partial steps are skipped
— with the same qids in the same slots; ticks come from the
``SlotTickCache`` (zero builds for structures the process has served).
With ``compact_every > 1`` the steps between full manifests write
``service_delta`` patches.

Observability (``obs``/``tracer``, ``repro_torch.obs``): both off by
default, and every call site on the tick path is behind an identity
check, so the disabled service adds no device synchronisation, no host
read and no clock read per tick.

The service runs on the card (``device=None`` means CUDA) unless the
caller passes ``device="cpu"``; its joins default to the CUDA kernel on
the card and to the plain version on the CPU (``JoinBackend``).  The
constructor's positional parameters are the reference's up to
``max_out``; the reference's next two, ``jit`` and ``donate``, have no
meaning here, so every parameter after ``max_out`` is keyword-only (a
positional call in the reference's order fails loudly instead of
shifting).  ``repro_torch.runtime.mesh.ShardedSearchService`` splits the
slot axis over replicas through the hooks here (``_place``,
``_Group.slot``, ``_group_tree``/``_set_group_state``,
``_trace_tick_extras``, ``_ckpt_save_kwargs``), and ``restore`` hands a
checkpoint whose config names a ``mesh`` to it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    CheckpointError,
    checkpoint_steps,
    dict_diff,
    load_resolved_manifest,
    restore_checkpoint,
    validate_checkpoint,
)
from repro_torch.core import join as J
from repro_torch.core.engine import NO_WATERMARK, TickResult, current_matches
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
from repro_torch.core.registry import (
    QueryRegistry,
    plan_decomposition,
    plan_signature,
)
from repro_torch.core.share import (
    SharedPrefixForest,
    SharedPrefixInfo,
    shared_current_matches,
)
from repro_torch.core.state import (
    EdgeBatch,
    EngineState,
    init_state,
    make_batch,
    map_state,
    resolve_device,
)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.straggler import TickCoalescer, quantize_pow2
from repro_torch.stream.generator import to_batches


def _restore_config(man: dict, overrides: dict, step: int) -> dict:
    """The checkpointed constructor config, without the reference's
    execution knobs (``jit``/``donate``: the port has neither); a join
    backend the port does not have needs an explicit override."""
    config = dict(man["config"])
    config.pop("jit", None)
    config.pop("donate", None)
    if "backend" not in overrides \
            and config.get("backend") not in J.JoinBackend.ALL:
        raise ValueError(
            f"checkpoint step {step} was served with join backend "
            f"{config.get('backend')!r}, which the port does not have; "
            f"pass backend= one of {J.JoinBackend.ALL} to restore it")
    return config


class ServeInfo(NamedTuple):
    """Per-tick record passed to ``serve_stream``'s ``on_tick`` callback
    (after the state update and any checkpoint).  ``latency_ms`` (and the
    ``tick.latency_ms`` histogram) times the dispatch of the forest and
    every group and the barrier only: neither the batch build nor
    delivery (the tracer's ``tick.batch`` and ``tick.deliver``)."""

    tick: int               # cumulative tick count (checkpoint step id)
    n_edges_ingested: int   # cumulative edges consumed after this tick
    chunk: int              # edges consumed by this tick
    latency_ms: float       # dispatch + barrier of this tick (all groups)
    n_overflow: int = 0     # dropped appends this tick, summed over qids
                            # (shared-prefix drops attributed per tenant)
    n_shared_prefix_ticks: int = 0   # forest nodes advanced this tick
    # ingest-frontier observability (``serve_frontier`` only; the plain
    # ``serve_stream`` path leaves the defaults)
    watermark: int | None = None     # event-time watermark after this tick
    n_late_dropped: int = 0          # frontier late drops this tick
    n_duplicates: int = 0            # suppressed duplicate deliveries, tick
    n_reconnects: int = 0            # source reconnects this tick
    n_dropped_forced_gap: int = 0    # capacity-pressure drops this tick
    watermark_lag: int = 0           # freshest data ts − watermark
    window_staleness: int = 0        # emit floor − watermark (forced gap)


@dataclass(eq=False)       # identity semantics: fields hold device tensors
class _Group:
    """One slot group: built tick + device state + slot ownership."""

    gid: int                          # stable id (checkpoint manifest key)
    template: ExecutionPlan
    tick: object                      # slot tick (SlotTickCache-shared)
    sstate: SlotState
    empty: EngineState                # cached init_state(template) for churn
    qids: list = field(default_factory=list)   # qid | None per slot
    prefix: object = None             # share.PrefixNode leaf | None
    # mesh service: ``sstate`` is a tuple of per-replica SlotStates, each
    # ``spr`` slots high (None: one SlotState holds every slot); over a
    # process group another rank's replica is None here
    spr: int | None = None

    def free_slot(self, lo: int = 0, hi: int | None = None) -> int | None:
        """First free slot in ``[lo, hi)`` (mesh placement restricts the
        search to one replica's contiguous slot block)."""
        hi = len(self.qids) if hi is None else hi
        for k in range(lo, hi):
            if self.qids[k] is None:
                return k
        return None

    def slot(self, k: int) -> tuple[SlotState | None, int]:
        """The SlotState holding slot ``k``, and k's row in it (None for
        a slot that another rank holds)."""
        if self.spr is None:
            return self.sstate, k
        return self.sstate[k // self.spr], k % self.spr

    def blocks(self) -> tuple:
        """Every SlotState of the group this process holds (one per
        replica on a mesh)."""
        return (self.sstate,) if self.spr is None else tuple(
            b for b in self.sstate if b is not None)

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
        *,
        ckpt_dir: str | None = None,
        keep_checkpoints: int = 8,
        tick_cache: SlotTickCache | None = None,
        enable_sharing: bool = False,
        compact_every: int = 1,
        obs: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.backend = J.resolve_backend(backend, self.device)
        self.slots_per_group = slots_per_group
        self.extract_matches = extract_matches
        self.max_out = max_out
        self.tick_cache = (GLOBAL_SLOT_TICK_CACHE if tick_cache is None
                           else tick_cache)
        self.ckpt_dir = ckpt_dir
        self.keep_checkpoints = keep_checkpoints
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.registry = QueryRegistry(
            level_capacity=level_capacity, l0_capacity=l0_capacity,
            max_new=max_new)
        # group key: (plan_signature, prefix-leaf pid | None) — every
        # slot of one group consumes ONE shared prefix view
        self._groups: dict[tuple, list[_Group]] = {}
        self._location: dict[int, tuple[_Group, int]] = {}
        self.forest = (SharedPrefixForest(
            self.tick_cache, backend=self.backend, device=self.device)
            if enable_sharing else None)
        self._prefix_of: dict[int, object] = {}   # qid -> leaf PrefixNode
        self._next_gid = 0
        self._frontier = None        # IngestFrontier bound by serve_frontier
        self.restored_ingest = None  # ingest manifest from restore()
        self._ckpt_step = 0          # last step id written (monotonic)
        if compact_every < 1:
            raise ValueError("compact_every must be >= 1")
        self.compact_every = compact_every
        self._last_manifest: dict | None = None   # resolved, last written
        self._last_man_step: int | None = None
        self._chain_len = 0          # delta steps since last compacted base
        self.n_compiles = 0          # build_slot_tick cache misses (this service)
        self.n_edges_ingested = 0
        self.n_ticks = 0
        # caller state carried inside every checkpoint manifest (the api
        # layer persists its vocab/pattern plans here); a dict, or a
        # zero-arg callable evaluated at checkpoint time
        self.manifest_extra: dict = {}
        # runtime knobs, not in the checkpointed config; the registry's
        # counter/histogram history rides in the manifest
        self.obs = obs
        self.tracer = tracer
        if obs is not None:
            self._register_obs_gauges()

    def _register_obs_gauges(self) -> None:
        """Collect-time callback gauges (snapshot cost, zero tick cost)."""
        obs = self.obs
        obs.register_gauge("tick.n_active", lambda: self.n_active)
        obs.register_gauge(
            "tick.n_groups",
            lambda: sum(len(gs) for gs in self._groups.values()))
        obs.register_gauge("tick.n_compiles", lambda: self.n_compiles)
        if self.ckpt is not None:
            obs.register_gauge("ckpt.stall_s", lambda: self.ckpt.stall_s)
        if self.forest is not None:
            self.forest.register_obs(obs)

    # ------------------------------------------------------------------ #
    @property
    def n_active(self) -> int:
        return len(self._location)

    def _iter_groups(self) -> list[_Group]:
        """All groups in stable gid order (manifest / serving order)."""
        return sorted((g for gs in self._groups.values() for g in gs),
                      key=lambda g: g.gid)

    def _new_group(self, template: ExecutionPlan, leaf=None) -> _Group:
        depth = 0 if leaf is None else leaf.depth
        before = self.tick_cache.n_builds
        tick = self.tick_cache.get(
            template, backend=self.backend,
            extract_matches=self.extract_matches, max_out=self.max_out,
            prefix_depth=depth)
        self.n_compiles += self.tick_cache.n_builds - before
        g = _Group(
            gid=self._next_gid,
            template=template,
            tick=tick,
            sstate=init_slot_state(template, self.slots_per_group, depth,
                                   device=self.device),
            empty=init_state(template, depth, device=self.device),
            qids=[None] * self.slots_per_group,
            prefix=leaf,
        )
        self._next_gid += 1
        return g

    def _place(self, groups: list, plan: ExecutionPlan, leaf,
               signature) -> tuple[_Group, int]:
        """Pick ``(group, slot)`` for a new tenant of this group key,
        allocating a fresh group when none has a free slot.  The single
        placement hook: the mesh service routes the choice through a
        replica ``PlacementPolicy`` and searches that replica's block."""
        for g in groups:
            k = g.free_slot()
            if k is not None:
                return g, k
        g = self._new_group(plan, leaf)
        groups.append(g)
        return g, 0

    # ------------------------------------------------------------------ #
    def register(self, query: QueryGraph, window: int,
                 plan: ExecutionPlan | None = None) -> int:
        """Add a standing query; returns its qid.

        A pure data write when a group with the same key has a free slot;
        an overflowing (or never-seen) structure allocates one new group,
        whose tick comes from the ``SlotTickCache`` — only a structure
        new to the process builds.  Pass ``plan`` to serve an exact
        pre-compiled plan (custom decomposition).
        """
        qid = self.registry.register(query, window, plan=plan)
        rq = self.registry.get(qid)
        leaf, gkey = None, None
        try:
            if self.forest is not None:
                # the chain at the CURRENT stream offset: only tenants
                # registered at the same offset may alias a node
                leaf = self.forest.acquire(rq.plan,
                                           epoch=self.n_edges_ingested)
                self._prefix_of[qid] = leaf
            gkey = (rq.signature, None if leaf is None else leaf.pid)
            groups = self._groups.setdefault(gkey, [])
            group, k = self._place(groups, rq.plan, leaf, rq.signature)
            block, row = group.slot(k)
            if block is not None:
                write_slot(block, group.template, row, rq.plan,
                           empty=group.empty)
        except Exception:
            # no half-registered tenant: roll the qid, any acquired
            # prefix references and an empty group-key entry back out
            self.registry.unregister(qid)
            if self._prefix_of.pop(qid, None) is not None:
                self.forest.release(leaf)
            if gkey is not None and not self._groups.get(gkey):
                self._groups.pop(gkey, None)
            raise
        group.qids[k] = qid
        self._location[qid] = (group, k)
        return qid

    def unregister(self, qid: int) -> None:
        """Drop a standing query and its partial-match state (data-only).

        A group whose slots all become empty is released, except that
        one idle group per structural signature is kept warm.  Under
        prefix sharing idle groups are dropped at once: their prefix node
        goes with the last tenant, and a later tenant of the structure
        starts a fresh epoch.  ``drop_idle_groups()`` reclaims the warm
        groups too.
        """
        group, k = self._location.pop(qid)
        block, row = group.slot(k)
        if block is not None:
            clear_slot(block, group.template, row, empty=group.empty)
        group.qids[k] = None
        self.registry.unregister(qid)
        leaf = self._prefix_of.pop(qid, None)
        if leaf is not None:
            self.forest.release(leaf)
        if group.idle:
            gkey = next(
                key for key, gs in self._groups.items() if group in gs)
            siblings = self._groups[gkey]
            n_idle = sum(1 for g in siblings if g.idle)
            if group.prefix is not None or n_idle > 1:
                siblings.remove(group)
                if not siblings:
                    del self._groups[gkey]

    def overflow_pressure(self, signature=None) -> int:
        """Cumulative dropped appends across active tenants — of one
        structural ``plan_signature``, or the whole service.  Host reads
        (one per group, one per live prefix node): call at admission or
        status time, not per tick."""
        if signature is not None:
            groups = [g for (sig, _), gs in self._groups.items()
                      if sig == signature for g in gs]
        else:
            groups = self._iter_groups()
        live = [g for g in groups if not g.idle]
        total = self._slot_overflow(live)
        if self.forest is not None:
            seen = set()
            for g in live:
                node = g.prefix
                while node is not None and node.pid not in seen:
                    seen.add(node.pid)
                    total += int(node.state.n_overflow)
                    node = node.parent
        return total

    def _slot_overflow(self, live) -> int:
        """The dropped appends of the slot tables of groups ``live``."""
        return sum(int(b.engines.stats.n_overflow.sum())
                   for g in live for b in g.blocks())

    def drop_idle_groups(self) -> int:
        """Release all fully-empty slot groups; returns how many were
        dropped.  Built ticks stay cached."""
        dropped = 0
        for key in list(self._groups):
            keep = [g for g in self._groups[key] if not g.idle]
            dropped += len(self._groups[key]) - len(keep)
            if keep:
                self._groups[key] = keep
            else:
                del self._groups[key]
        return dropped

    # ------------------------------------------------------------------ #
    def _batch(self, batch) -> EdgeBatch:
        if isinstance(batch, EdgeBatch):
            return batch
        return make_batch(**batch, device=self.device)

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _advance_forest(self, batch: EdgeBatch, watermark=None):
        """The dedicated prefix tick: every live forest node advances
        once per service tick.  Returns the per-node views and per-node
        overflow scalars by pid (device tensors)."""
        if self.forest is None or not len(self.forest):
            return {}, {}
        return self.forest.advance(batch, watermark)

    def _advance_group(self, g: _Group, batch: EdgeBatch, views=None,
                       forest_nds=None, watermark=None):
        """One tick of one group.  A shared-prefix group's result comes
        back with each armed slot's ``n_overflow`` raised by its chain's
        drops this tick (a tensor add on the device), so per-tenant
        counters read as the unshared engine's would."""
        if g.prefix is not None:
            g.sstate, res = g.tick(g.sstate, batch, views[g.prefix.pid],
                                   watermark)
            chain_nd = self.forest.chain_tick_overflow(g.prefix, forest_nds)
            res = res._replace(
                n_overflow=res.n_overflow + torch.where(
                    g.sstate.params.active, chain_nd,
                    torch.zeros_like(chain_nd)))
        else:
            g.sstate, res = g.tick(g.sstate, batch, watermark)
        return res

    def ingest(self, batch, watermark=None) -> dict[int, TickResult]:
        """Advance all standing queries by one batch of stream edges.

        ``batch`` is an EdgeBatch or a dict of arrays (``to_batches``
        output).  Returns a per-qid TickResult (views of each group's
        stacked result).  ``watermark`` switches the engines to
        event-time admission/expiry; None keeps the max-ts clock.
        """
        batch = self._batch(batch)
        views, forest_nds = self._advance_forest(batch, watermark)
        out: dict[int, TickResult] = {}
        for g in self._iter_groups():
            if g.idle:
                continue
            res = self._advance_group(g, batch, views, forest_nds,
                                      watermark)
            for k, qid in self._result_slots(g):
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
        ckpt_every: int = 0,
        batch_size: int = 64,
        min_batch: int | None = None,
        max_batch: int | None = None,
        target_latency_ms: float = 50.0,
        coalescer: TickCoalescer | None = None,
        final_checkpoint: bool = True,
    ) -> dict[int, int]:
        """Drive the service over a DataEdge list (the production loop).

        A ``TickCoalescer`` adapts the chunk size to the measured tick
        latency, queue depth and overflow; chunks are padded to power-of-
        two shapes.  The forest and all groups are dispatched, then the
        loop meets ONE barrier per tick (``torch.cuda.synchronize`` on the
        card), so the measured latency is what every group experiences.
        ``on_match(qid, bindings, ets)`` fires for each tenant's new
        matches; ``on_tick(ServeInfo)`` after each tick's state update
        (and checkpoint, if due) — an exception raised from it leaves the
        last checkpoint consistent.  With ``ckpt_dir`` set and
        ``ckpt_every > 0`` the service is checkpointed every that-many
        ticks, plus once at the end of the call if ticks advanced past
        the last written step (``final_checkpoint=False`` keeps the
        strict cadence); pending writes are flushed before returning.
        Pass ``coalescer`` to carry the AIMD state across calls.  Returns
        ``{qid: total new matches}`` over the served span.
        """
        if on_match is not None and not self.extract_matches:
            raise ValueError(
                "on_match requires a service with extract_matches=True")
        if ckpt_every and self.ckpt is None:
            raise ValueError(
                "ckpt_every requires a service with ckpt_dir set — "
                "without it every checkpoint would be a silent no-op")
        if coalescer is None:
            coalescer = TickCoalescer.seeded(
                batch_size, min_batch, max_batch, target_latency_ms)
        totals: dict[int, int] = {}
        i, n = 0, len(edges)
        while i < n:
            chunk = edges[i:i + coalescer.batch]
            queue_depth = n - (i + len(chunk))
            lat_ms, tick_overflow, n_shared = self._tick_chunk(
                chunk, on_match, totals)
            coalescer.record(lat_ms, queue_depth, tick_overflow)
            if self.obs is not None:
                self._observe_coalescer(coalescer)
            i += len(chunk)
            if self.ckpt and ckpt_every and self.n_ticks % ckpt_every == 0:
                self.checkpoint()
            if on_tick is not None:
                on_tick(ServeInfo(
                    tick=self.n_ticks,
                    n_edges_ingested=self.n_edges_ingested,
                    chunk=len(chunk),
                    latency_ms=lat_ms,
                    n_overflow=tick_overflow,
                    n_shared_prefix_ticks=n_shared,
                ))
        self._final_checkpoint(ckpt_every, final_checkpoint)
        return totals

    def _tick_chunk(self, chunk: list, on_match, totals: dict,
                    watermark=None) -> tuple[float, int, int]:
        """One production tick over ``chunk``: pow-2 padded batch, the
        forest and every group dispatched, ONE barrier, then one host
        copy of each group's result and match delivery.  Returns
        (latency ms, tick overflow, shared-prefix node count); the
        latency times dispatch and the barrier, not the batch build nor
        delivery."""
        tr = self.tracer
        if tr is not None:
            tr.next_tick()
        active = [g for g in self._iter_groups() if not g.idle]
        if tr is not None:
            t_batch = time.perf_counter()
        width = quantize_pow2(len(chunk))
        batch = make_batch(**to_batches(chunk, width)[0], device=self.device)
        t0 = time.perf_counter()
        views, forest_nds = self._advance_forest(batch, watermark)
        if tr is None:
            results = [(g, self._advance_group(g, batch, views,
                                               forest_nds, watermark))
                       for g in active]
        else:
            # stage wall clocks from bare perf_counter reads reported
            # post hoc: the tracer-off branch above reads no extra clock.
            # marks[i] ends the forest (i = 0) or group i's dispatch and
            # starts the next stage; the stages are recorded once the
            # tick is delivered, so that no tracer work runs between
            # them
            marks = [time.perf_counter()]
            results = []
            for g in active:
                results.append((g, self._advance_group(
                    g, batch, views, forest_nds, watermark)))
                marks.append(time.perf_counter())
            tb = marks[-1]
        self._barrier()
        t_end = time.perf_counter()
        lat_ms = (t_end - t0) * 1e3
        if tr is not None:
            tr.record("tick.barrier", (t_end - tb) * 1e3, start=tb)
            self._trace_tick_extras(tr)
        tick_overflow = 0
        n_matches = 0
        delivered = []      # tracer on: each group's copy and match records
        for g, res in results:
            if tr is not None:
                t_copy = time.perf_counter()
            host = map_state(lambda x: x.cpu().numpy(), res)
            if tr is not None:
                t_rows = time.perf_counter()
                n_group = n_matches
            for k, qid in self._result_slots(g):
                n_new = int(host.n_new_matches[k])
                tick_overflow += int(host.n_overflow[k])
                n_matches += n_new
                totals[qid] = totals.get(qid, 0) + n_new
                if n_new and on_match is not None:
                    valid = host.match_valid[k]
                    on_match(qid, host.match_bindings[k][valid],
                             host.match_ets[k][valid])
            if tr is not None:
                delivered.append((g.gid, res, n_matches - n_group, t_copy,
                                  t_rows, time.perf_counter()))
        lat_ms, tick_overflow = self._agree_tick(lat_ms, tick_overflow)
        if tr is not None:
            tr.record("tick.deliver",
                      (time.perf_counter() - t_end) * 1e3, start=t_end,
                      n_matches=n_matches)
            for gid, res, n_group, t_copy, t_rows, t_done in delivered:
                # bytes from the leaves' metadata: no device read
                tr.record("deliver.copy", (t_rows - t_copy) * 1e3,
                          start=t_copy, gid=gid,
                          bytes=sum(x.nbytes for x in res))
                tr.record("deliver.matches", (t_done - t_rows) * 1e3,
                          start=t_rows, gid=gid, n_matches=n_group)
            tr.record("tick.batch", (t0 - t_batch) * 1e3, start=t_batch,
                      n_edges=len(chunk), width=width)
            tr.record("tick.forest", (marks[0] - t0) * 1e3, start=t0,
                      n_nodes=len(views))
            for (g, _), ts, te in zip(results, marks, marks[1:]):
                tr.record("tick.slot_dispatch", (te - ts) * 1e3, start=ts,
                          gid=g.gid)
        self.n_ticks += 1
        self.n_edges_ingested += len(chunk)
        obs = self.obs
        if obs is not None:
            obs.histogram("tick.latency_ms").observe(lat_ms)
            obs.counter("tick.n_ticks").inc()
            obs.counter("tick.n_edges").inc(len(chunk))
            obs.counter("tick.n_matches").inc(n_matches)
            obs.counter("tick.n_overflow").inc(tick_overflow)
            if views:
                obs.counter("share.n_prefix_ticks").inc(len(views))
        return lat_ms, tick_overflow, len(views)

    def _result_slots(self, g: _Group):
        """``(row of the group's tick result, qid)`` of every live slot
        whose result this process holds."""
        return [(k, q) for k, q in enumerate(g.qids) if q is not None]

    def _agree_tick(self, lat_ms: float, tick_overflow: int):
        """The tick's latency and overflow as the coalescer reads them;
        the mesh service over a process group agrees them across the
        ranks."""
        return lat_ms, tick_overflow

    def _trace_tick_extras(self, tr: Tracer) -> None:
        """Tracer-on hook after the tick barrier — the mesh service
        emits its cross-replica scalars here; the base service has
        none."""

    def _observe_coalescer(self, coalescer: TickCoalescer) -> None:
        """Mirror the AIMD decision just taken into ``coalescer.*`` (obs-on
        path only — callers guard on ``self.obs``)."""
        self.obs.counter(f"coalescer.{coalescer.last_action}").inc()
        self.obs.gauge("coalescer.batch").set(coalescer.batch)
        if self.tracer is not None:
            self.tracer.event("coalescer.decision",
                              action=coalescer.last_action,
                              batch=coalescer.batch)

    def _final_checkpoint(self, ckpt_every: int, final: bool) -> None:
        if self.ckpt:
            if ckpt_every and final and \
                    self.n_ticks % ckpt_every != 0 and \
                    self.n_ticks > self._ckpt_step:
                self.checkpoint()       # final end-of-call durability
            self.ckpt.wait()

    def _watermark_scalar(self, wm: int | None) -> torch.Tensor:
        """The tick's event-time watermark as ONE int32 device scalar,
        filled on the device (no host-to-device copy); every group and
        forest node of the tick reads this tensor.  ``NO_WATERMARK`` is
        the "unknown yet" identity of the event-time clock."""
        return torch.full((), NO_WATERMARK if wm is None else wm,
                          dtype=torch.int32, device=self.device)

    def serve_frontier(
        self,
        frontier,
        on_match=None,
        on_tick=None,
        ckpt_every: int = 0,
        batch_size: int = 64,
        min_batch: int | None = None,
        max_batch: int | None = None,
        target_latency_ms: float = 50.0,
        coalescer: TickCoalescer | None = None,
        final_checkpoint: bool = True,
        pump_size: int = 64,
        max_idle_rounds: int | None = None,
    ) -> dict[int, int]:
        """Drive the service from an ``IngestFrontier`` (the real-traffic
        production loop): sources -> retry/dedup -> k-way merge ->
        watermark -> tick.

        The coalescer ticks on WATERMARK ADVANCE, not arrival order:
        each round pumps every live source (``pump_size`` deliveries a
        source at most), takes the events the watermark has released
        (in merged event-time order, at most the coalescer's batch), and
        ticks only when something is ready — an all-sources stall is an
        idle round (``TickCoalescer.record_idle``), not a tick.  The
        frontier stays bound to the service, so checkpoints embed its
        resume state (per-source ack cursors, emit floor, watermark):
        ``restore`` surfaces it as ``restored_ingest`` and
        ``IngestFrontier.resume`` picks the stream back up exactly once.

        Event time end to end: each tick hands the frontier's
        ``watermark()`` to every engine and forest node as one int32
        device scalar (built once per tick, filled on the device), so
        window admission and expiry follow event time, not the order
        the reorder buffer released in.

        ``ServeInfo`` gains the frontier fields: ``watermark``, the
        ``watermark_lag`` / ``window_staleness`` gauges, and the per-tick
        ``n_late_dropped`` / ``n_dropped_forced_gap`` / ``n_duplicates``
        / ``n_reconnects`` deltas.  ``max_idle_rounds`` bounds how many
        consecutive empty rounds to tolerate before returning (None:
        serve until every source is exhausted; a source whose retry
        budget is spent counts as exhausted).  With a tracer, each tick
        records ``ingest.pump`` and ``ingest.release`` spans; with a
        registry, ``frontier.publish_obs`` mirrors the frontier's
        counters under ``ingest.*`` — both behind identity checks, so a
        service with both off reads no extra clock.  Returns ``{qid:
        total new matches}``.
        """
        if on_match is not None and not self.extract_matches:
            raise ValueError(
                "on_match requires a service with extract_matches=True")
        if ckpt_every and self.ckpt is None:
            raise ValueError(
                "ckpt_every requires a service with ckpt_dir set — "
                "without it every checkpoint would be a silent no-op")
        if coalescer is None:
            coalescer = TickCoalescer.seeded(
                batch_size, min_batch, max_batch, target_latency_ms)
        totals: dict[int, int] = {}
        # stays bound after return, so later checkpoints (tenant churn,
        # shutdown) keep embedding the stream cursors
        self._frontier = frontier
        prev = frontier.stats()
        idle = 0
        while not frontier.exhausted:
            tr = self.tracer
            t_pump = time.perf_counter() if tr is not None else 0.0
            frontier.pump(pump_size)
            t_rel = time.perf_counter() if tr is not None else 0.0
            chunk = frontier.take_ready(limit=coalescer.batch)
            t_done = time.perf_counter() if tr is not None else 0.0
            if not chunk:
                idle += 1
                coalescer.record_idle()
                if self.obs is not None:
                    self._observe_coalescer(coalescer)
                if max_idle_rounds is not None and idle > max_idle_rounds:
                    break
                continue
            idle = 0
            wm_in = self._watermark_scalar(frontier.watermark())
            lat_ms, tick_overflow, n_shared = self._tick_chunk(
                chunk, on_match, totals, wm_in)
            if tr is not None:
                # recorded after _tick_chunk so the spans carry this
                # tick's correlation id (next_tick advances in there)
                tr.record("ingest.pump", (t_rel - t_pump) * 1e3,
                          start=t_pump)
                tr.record("ingest.release", (t_done - t_rel) * 1e3,
                          start=t_rel,
                          n_released=len(chunk))
            coalescer.record(lat_ms, frontier.buffered, tick_overflow)
            if self.obs is not None:
                self._observe_coalescer(coalescer)
                frontier.publish_obs(self.obs)
            if self.ckpt and ckpt_every and \
                    self.n_ticks % ckpt_every == 0:
                self.checkpoint()
            if on_tick is not None:
                cur = frontier.stats()
                on_tick(ServeInfo(
                    tick=self.n_ticks,
                    n_edges_ingested=self.n_edges_ingested,
                    chunk=len(chunk),
                    latency_ms=lat_ms,
                    n_overflow=tick_overflow,
                    n_shared_prefix_ticks=n_shared,
                    watermark=cur.watermark,
                    n_late_dropped=cur.n_late_dropped
                    - prev.n_late_dropped,
                    n_duplicates=cur.n_duplicates - prev.n_duplicates,
                    n_reconnects=cur.n_reconnects - prev.n_reconnects,
                    n_dropped_forced_gap=cur.n_dropped_forced_gap
                    - prev.n_dropped_forced_gap,
                    watermark_lag=cur.watermark_lag,
                    window_staleness=cur.window_staleness,
                ))
                prev = cur
        self._final_checkpoint(ckpt_every, final_checkpoint)
        return totals

    # ------------------------------------------------------------------ #
    # checkpoint / restore
    # ------------------------------------------------------------------ #
    def _manifest(self) -> dict:
        """JSON-serializable description of everything that is NOT a
        device tensor: config, registry, slot layout, forest, counters.
        The reference's keys; ``config.backend`` names the port's join
        backend, and ``jit``/``donate`` are False (the port has neither).
        ``ingest`` is the bound frontier's resume state (per-source ack
        cursors, emit floor, watermark, counters), None before any
        ``serve_frontier``."""
        extra = (self.manifest_extra() if callable(self.manifest_extra)
                 else self.manifest_extra)
        return {
            "extra": extra,
            "config": {
                "slots_per_group": self.slots_per_group,
                "level_capacity": self.registry.level_capacity,
                "l0_capacity": self.registry.l0_capacity,
                "max_new": self.registry.max_new,
                "backend": self.backend,
                "extract_matches": self.extract_matches,
                "max_out": self.max_out,
                "jit": False,
                "donate": False,
                "keep_checkpoints": self.keep_checkpoints,
                "enable_sharing": self.forest is not None,
                "compact_every": self.compact_every,
            },
            "queries": {
                str(qid): {
                    "query": self.registry.get(qid).query.to_spec(),
                    "window": int(self.registry.get(qid).window),
                    # exact plan round-trip: restore bypasses the
                    # decomposition heuristics (custom plans survive)
                    "decomposition": [
                        list(seq) for seq in
                        plan_decomposition(self.registry.get(qid).plan)
                    ],
                }
                for qid in self.registry.qids()
            },
            # keyed by gid: stable keys keep churn deltas O(changed groups)
            "groups": {
                str(g.gid): {
                    "template_query": g.template.query.to_spec(),
                    "template_window": int(g.template.window),
                    "template_decomposition": [
                        list(seq) for seq in plan_decomposition(g.template)
                    ],
                    "qids": list(g.qids),
                    "prefix_pid": (None if g.prefix is None
                                   else g.prefix.pid),
                }
                for g in self._iter_groups()
            },
            "forest": (None if self.forest is None
                       else self.forest.to_manifest()),
            # stays bound after serve_frontier returns, so a later
            # checkpoint still carries the stream cursors
            "ingest": (None if self._frontier is None
                       else self._frontier.to_manifest()),
            "counters": {
                "n_edges_ingested": int(self.n_edges_ingested),
                "n_ticks": int(self.n_ticks),
                "next_qid": int(self.registry.next_qid),
            },
            "obs": (None if self.obs is None else self.obs.to_manifest()),
        }

    def _group_tree(self, g: _Group):
        """One group's state as the checkpoint holds it: a SlotState
        whose leaves carry the whole slot axis."""
        return g.sstate

    def _set_group_state(self, g: _Group, sstate) -> None:
        """Install a restored whole-slot-axis SlotState into ``g``."""
        g.sstate = sstate

    def _restore_arrays(self, ckpt_dir: str, step: int, like: dict) -> dict:
        """The arrays of ``like`` (``_ckpt_tree``'s layout) from
        checkpoint ``step``."""
        return restore_checkpoint(ckpt_dir, step, like)

    def _ckpt_tree(self) -> dict:
        tree = {str(g.gid): self._group_tree(g) for g in self._iter_groups()}
        if self.forest is not None:
            tree.update({f"prefix{n.pid}": n.state
                         for n in self.forest.nodes()})
        return tree

    def _ckpt_save_kwargs(self) -> dict:
        """Extra ``AsyncCheckpointer.save`` kwargs — the mesh service
        splits its slot axis into per-replica shard files."""
        return {}

    def checkpoint(self, step: int | None = None):
        """Snapshot all groups' ``SlotState`` and the forest's node
        states plus the service manifest.  The host copy is made before
        this returns (the next tick updates the tables in place); the
        files are written on the writer thread.  Returns the writer
        future (``self.ckpt.wait()`` blocks on durability).

        Step ids are strictly monotonic even when the tick count has not
        advanced.  With ``compact_every > 1``, at most every K-th step
        carries the full manifest; the steps between write
        ``service_delta`` patches against the previous step (arrays are
        always complete).
        """
        if self.ckpt is None:
            raise ValueError("service was constructed without ckpt_dir")
        t0 = time.perf_counter() if (self.obs is not None
                                     or self.tracer is not None) else 0.0
        if step is None:
            step = max(self.n_ticks, self._ckpt_step + 1)
        self._ckpt_step = max(self._ckpt_step, step)
        man = self._manifest()
        if (self._last_manifest is not None
                and self._chain_len + 1 < self.compact_every):
            extra = {"service_delta": {
                "prev": self._last_man_step,
                "patch": dict_diff(self._last_manifest, man)}}
            self._chain_len += 1
        else:
            extra = {"service": man}
            self._chain_len = 0
        self._last_manifest = man
        self._last_man_step = step
        fut = self.ckpt.save(step, self._ckpt_tree(), extra=extra,
                             keep_last=self.keep_checkpoints,
                             **self._ckpt_save_kwargs())
        if self.obs is not None or self.tracer is not None:
            # the synchronous publish cost: manifest + host snapshot
            ms = (time.perf_counter() - t0) * 1e3
            if self.obs is not None:
                self.obs.histogram("ckpt.publish_ms").observe(ms)
                self.obs.counter("ckpt.n_checkpoints").inc()
            if self.tracer is not None:
                self.tracer.record("ckpt.publish", ms, start=t0,
                                   step=int(step))
                self.tracer.flush()
        return fut

    @classmethod
    def restore(
        cls,
        ckpt_dir: str,
        step: int | None = None,
        tick_cache: SlotTickCache | None = None,
        backend: str | None = None,
        extract_matches: bool | None = None,
        obs: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        *,
        device=None,
    ) -> "ContinuousSearchService":
        """Rebuild a full multi-tenant service from a checkpoint.

        Uses the newest *usable* checkpoint (or ``step`` if given) —
        torn/partial checkpoints are skipped.  Every query comes back
        under its original qid in its original slot, and the ticks come
        from the ``SlotTickCache``: a structure this process has served
        restores with zero builds.  The state lands on ``device``
        (``None``: the card).

        ``backend`` / ``extract_matches`` override the checkpointed
        config.  A checkpoint written by the reference package names a
        backend the port does not have (``"pallas"``...): it restores
        only with an explicit ``backend=``.  A checkpoint written by a
        ``ShardedSearchService`` (its config names a ``mesh``) comes back
        as one, on the same number of replicas, every replica on
        ``device`` when it is given.
        """
        candidates = ([step] if step is not None
                      else list(reversed(checkpoint_steps(ckpt_dir))))
        overrides = {}
        if backend is not None:
            overrides["backend"] = backend
        if extract_matches is not None:
            overrides["extract_matches"] = extract_matches
        if obs is not None:
            overrides["obs"] = obs
        if tracer is not None:
            overrides["tracer"] = tracer
        last_err: CheckpointError | None = None
        for s in candidates:
            try:
                return cls._restore_step(ckpt_dir, s, tick_cache, overrides,
                                         device)
            except CheckpointError as e:
                last_err = e
        raise CheckpointError(
            f"no usable service checkpoint under {ckpt_dir!r}") from last_err

    @classmethod
    def _restore_step(cls, ckpt_dir, step, tick_cache, overrides, device):
        validate_checkpoint(ckpt_dir, step)   # torn pair / file -> skip
        # resolves service_delta chains back to the last full manifest;
        # a torn link raises CheckpointError (fall back a step)
        man = load_resolved_manifest(ckpt_dir, step, "service")
        config = _restore_config(man, overrides, step)
        if "mesh" in config and not getattr(cls, "_MESH_SERVICE", False):
            # written by a ShardedSearchService, restored through the
            # base class: delegate
            from repro_torch.runtime.mesh import ShardedSearchService
            return ShardedSearchService._restore_step(
                ckpt_dir, step, tick_cache, overrides, device)
        svc = cls(ckpt_dir=ckpt_dir, tick_cache=tick_cache, device=device,
                  **{**config, **overrides})
        svc.manifest_extra = man.get("extra", {})
        svc.restored_ingest = man.get("ingest")
        for qid_s, ent in man["queries"].items():
            svc.registry.adopt(
                int(qid_s), QueryGraph.from_spec(ent["query"]),
                int(ent["window"]),
                decomposition=ent.get("decomposition"))
        by_pid = {}
        if svc.forest is not None and man.get("forest"):
            by_pid = svc.forest.restore_nodes(man["forest"])
        like = {}
        for gid_s, gspec in sorted(man["groups"].items(),
                                   key=lambda kv: int(kv[0])):
            template = svc.registry.compile(
                QueryGraph.from_spec(gspec["template_query"]),
                int(gspec["template_window"]),
                decomposition=gspec.get("template_decomposition"))
            pid = gspec.get("prefix_pid")
            leaf = None if pid is None else by_pid[int(pid)]
            g = svc._new_group(template, leaf)
            g.gid = int(gid_s)
            g.qids = [None if q is None else int(q) for q in gspec["qids"]]
            gkey = (plan_signature(template),
                    None if leaf is None else leaf.pid)
            svc._groups.setdefault(gkey, []).append(g)
            for k, qid in enumerate(g.qids):
                if qid is not None:
                    svc._location[qid] = (g, k)
                    if leaf is not None:
                        # one chain of references per restored tenant —
                        # refcounts are rebuilt, not trusted blindly
                        svc._prefix_of[qid] = svc.forest.adopt(leaf)
            like[str(g.gid)] = svc._group_tree(g)
        if svc.forest is not None and man.get("forest"):
            want = {int(e["pid"]): int(e["refcount"])
                    for e in man["forest"]["nodes"]}
            got = {n.pid: n.refcount for n in svc.forest.nodes()}
            if want != got:
                raise CheckpointError(
                    f"step {step}: forest refcounts disagree with the "
                    f"manifest (manifest {want}, rebuilt {got})")
            for n in svc.forest.nodes():
                like[f"prefix{n.pid}"] = n.state
        svc._next_gid = 1 + max(
            (int(gid) for gid in man["groups"]), default=-1)
        restored = svc._restore_arrays(ckpt_dir, step, like)
        for g in svc._iter_groups():
            svc._set_group_state(g, restored[str(g.gid)])
        if svc.forest is not None:
            for n in svc.forest.nodes():
                n.state = restored[f"prefix{n.pid}"]
        counters = man["counters"]
        svc.n_edges_ingested = int(counters["n_edges_ingested"])
        svc.n_ticks = int(counters["n_ticks"])
        svc._ckpt_step = int(step)
        svc.registry._next_qid = max(
            svc.registry._next_qid, int(counters["next_qid"]))
        if svc.obs is not None and man.get("obs"):
            svc.obs.load_manifest(man["obs"])
        return svc

    # ------------------------------------------------------------------ #
    def state(self, qid: int) -> EngineState:
        """This query's (unstacked) engine state (under prefix sharing:
        the suffix levels only — the shared prefix lives in the forest)."""
        group, k = self._location[qid]
        return read_slot(*group.slot(k))

    def matches(self, qid: int):
        """All complete matches currently in the query's window."""
        group, _ = self._location[qid]
        plan = self.registry.get(qid).plan
        if group.prefix is None:
            return current_matches(plan, self.state(qid))
        return shared_current_matches(plan, group.prefix, self.forest,
                                      self.state(qid))

    def stats(self, qid: int):
        return self.state(qid).stats

    # ------------------------------------------------------------------ #
    # prefix-sharing observability
    # ------------------------------------------------------------------ #
    def shared_prefix(self, qid: int) -> SharedPrefixInfo | None:
        """Sharing stats for one tenant, or None when the service runs
        unshared."""
        leaf = self._prefix_of.get(qid)
        if leaf is None:
            return None
        return SharedPrefixInfo(depth=leaf.depth, n_tenants=leaf.refcount,
                                epoch=leaf.epoch)

    def forest_stats(self):
        """Aggregate ``ForestStats`` of the shared-prefix forest (None
        when sharing is disabled)."""
        return None if self.forest is None else self.forest.stats()

    def tenant_overflow(self, qid: int) -> int:
        """Cumulative dropped appends affecting this tenant: its own
        suffix/L0 tables plus (under sharing) its prefix chain."""
        total = int(self.stats(qid).n_overflow)
        leaf = self._prefix_of.get(qid)
        if leaf is not None:
            total += self.forest.chain_overflow(leaf)
        return total
