"""Replica-sharded multi-tenant serving: the slot (tenant) axis on a mesh.

The port of ``repro.runtime.mesh``.  A ``ShardedSearchService`` keeps
the whole ``ContinuousSearchService`` contract (register / unregister /
ingest / serve_stream / serve_frontier / checkpoint / restore) but
stacks each slot group ``n_replicas x slots_per_replica`` tenants high
and splits the slot axis over a mesh of replicas:

* the mesh is an ordered tuple of torch devices, one per replica; a
  device may appear more than once (R logical replicas on one card, or
  on the CPU in the tests — the counterpart of the reference's forced
  host device count);
* replica ``r`` owns the contiguous slot block ``[r*spr, (r+1)*spr)``:
  a group's ``sstate`` is a tuple of per-replica ``SlotState``s, block
  ``r``'s leaves on ``mesh[r]``, so a replica materialises only its own
  tenants' tables;
* the batch, the prefix views and the watermark scalar are replicated —
  copied once per distinct device per tick, which on one card is no
  copy at all;
* the mesh tick runs the plain slot tick over each block on its device
  (every replica enqueued before any wait) — no collective inside the
  body; the only cross-replica values are three scalars per tick
  (``MeshTickStats``: matches and overflow summed, the engines' clock
  maxed), formed on ``mesh[0]`` without a host read, and the
  per-replica ``TickResult``s concatenated on ``mesh[0]``;
* a ``PlacementPolicy`` decides which replica each newly registered
  tenant lands on (round-robin, or load-balanced by overflow pressure
  and tenant count); the slot search inside the chosen replica's block
  is ``_Group.free_slot(lo, hi)``.

Two meshes.  Without ``group`` one controller drives every replica.
With ``group`` (a ``torch.distributed`` process group of W ranks, one a
device) replica ``r``'s slot block lives on rank ``r // (R / W)``, and
every rank runs the host side identically, in SPMD style — the same
registrations, placements, coalescer decisions and forest advances, in
the same order — while it ticks only its own blocks.  The cross-replica
scalars are then collectives: ``MeshTickStats`` is all-gathered and
reduced (matches and overflow summed, the clock maxed) inside the tick,
the placement's overflow pressure is gathered, and each tick's latency
and overflow, which steer the coalescer, are agreed.  A
tenant's matches are delivered by the rank that holds it; the union
over the ranks is the single-device service's.  Rank r writes the
shard files of its replicas and rank 0 the manifest, after the ranks
have exchanged their hashes.

Prefix sharing composes: the ``SharedPrefixForest`` advances once per
tick on ``mesh[0]``, outside the replicas, and its views enter every
replica's suffix joins replicated.  ``SharedPrefixForest.
replica_refcounts`` splits each node's refcount by owning replica, so
checkpoint manifests record (and restore verifies) the partition.

Checkpoints are sharded: each step writes ``step_N.shard<r>of<R>.npz``
(slot-axis keys split along axis 0; forest tables and scalars in shard
0) plus one manifest, in the reference's format.  ``restore``
reassembles them on the host, so a checkpoint written on 8 replicas
restores onto 2 (or the other way): the same size re-arms the exact
slot layout with zero builds; a different ``n_replicas`` re-places every
tenant with the policy and splices its engine rows into its new slot.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (
    CheckpointError,
    checkpoint_steps,
    load_resolved_manifest,
    restore_checkpoint,
    validate_checkpoint,
)
from repro_torch.core import join as J
from repro_torch.core.distributed import P, make_mesh
from repro_torch.core.multi import (
    SlotState,
    SlotTickCache,
    build_slot_tick,
    init_slot_state,
    write_slot,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.state import init_state, map_state, resolve_device
from repro_torch.runtime.service import (
    ContinuousSearchService,
    _Group,
    _restore_config,
)

I32 = torch.int32


class MeshTickStats(NamedTuple):
    """Per-tick scalar reductions across the replicas (the mesh tick's
    third output; int32 scalars on ``mesh[0]``)."""

    n_matches: torch.Tensor   # new matches summed over all replicas
    n_overflow: torch.Tensor  # dropped appends summed over all replicas
    t_clock: torch.Tensor     # the largest engine clock of any replica


def _mesh_device(d) -> torch.device:
    """A mesh entry as a torch device with an explicit CUDA index (so
    ``"cuda"`` and ``"cuda:0"`` name one replica device)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _replicate(tree, devices):
    """``{device: tree on that device}`` for each distinct device; a
    leaf already there is not copied."""
    def to(x, dev):
        return x.to(dev, non_blocking=True) if torch.is_tensor(x) else x

    return {d: (None if tree is None
                else map_state(lambda x, d=d: to(x, d), tree))
            for d in devices}


# --------------------------------------------------------------------- #
# The mesh slot tick
# --------------------------------------------------------------------- #
def build_mesh_slot_tick(
    template_plan: ExecutionPlan,
    mesh,
    backend: str = J.JoinBackend.REF,
    extract_matches: bool = True,
    max_out: int | None = None,
    *,
    prefix_depth: int = 0,
    group=None,
):
    """Run ``build_slot_tick`` over every replica block of ``mesh`` (a
    sequence of devices, one per replica).

    The returned callable keeps the slot tick's signature —
    ``tick(blocks, batch, watermark=None)``, or with ``prefix_depth``
    ``tick(blocks, batch, prefix_view, watermark=None)`` — where
    ``blocks`` is a tuple of per-replica ``SlotState``s (block ``r`` on
    ``mesh[r]``), and returns ``(blocks, results, MeshTickStats)``:
    ``results`` is one ``TickResult`` over the whole slot axis on
    ``mesh[0]``.  Batch, prefix view and watermark are replicated onto
    each distinct device; every replica's body is enqueued before
    anything waits, and nothing is read back to the host.

    With ``group`` ``mesh`` lists this rank's replicas only, and the
    ``MeshTickStats`` are the group's: one ``all_gather_into_tensor`` of
    the three scalars, reduced on the device.
    """
    devices = tuple(_mesh_device(d) for d in mesh)
    home = devices[0]
    distinct = tuple(dict.fromkeys(devices))
    inner = build_slot_tick(template_plan, backend=backend,
                            extract_matches=extract_matches,
                            max_out=max_out, prefix_depth=prefix_depth)
    # kernels launch on the current CUDA device: switch only when the
    # replicas span more than one card
    switch = len(distinct) > 1

    def on(dev):
        return torch.cuda.device(dev) if switch and dev.type == "cuda" \
            else contextlib.nullcontext()

    def home_cat(*xs):
        if len(xs) == 1:
            return xs[0]
        return torch.cat([x.to(home, non_blocking=True) for x in xs])

    def run(blocks, batch, view, watermark):
        batches = _replicate(batch, distinct)
        views = _replicate(view, distinct)
        wms = _replicate(watermark, distinct)
        new, results = [], []
        for blk, dev in zip(blocks, devices):
            with on(dev):
                if prefix_depth:
                    s, r = inner(blk, batches[dev], views[dev], wms[dev])
                else:
                    s, r = inner(blk, batches[dev], wms[dev])
            new.append(s)
            results.append(r)
        res = map_state(home_cat, *results)
        clocks = [s.engines.t_now.max() for s in new]
        stats = MeshTickStats(
            n_matches=res.n_new_matches.sum().to(I32),
            n_overflow=res.n_overflow.sum().to(I32),
            t_clock=home_cat(*[c[None] for c in clocks]).max())
        if group is not None:
            stats = _group_stats(stats, group)
        return tuple(new), res, stats

    if prefix_depth == 0:
        def tick(blocks, batch, watermark=None):
            return run(blocks, batch, None, watermark)
    else:
        def tick(blocks, batch, prefix_view, watermark=None):
            return run(blocks, batch, prefix_view, watermark)
    return tick


def _group_stats(stats: MeshTickStats, group) -> MeshTickStats:
    """The group's ``MeshTickStats`` from each rank's: one all-gather of
    the three int32 scalars, summed and maxed on the device."""
    mine = torch.stack(list(stats))
    out = mine.new_empty((dist.get_world_size(group) * 3,))
    dist.all_gather_into_tensor(out, mine, group=group)
    out = out.view(-1, 3)
    return MeshTickStats(n_matches=out[:, 0].sum().to(I32),
                         n_overflow=out[:, 1].sum().to(I32),
                         t_clock=out[:, 2].max())


def _gather_host(values, group, device) -> np.ndarray:
    """Every rank's host numbers, ``[ranks, len(values)]`` float64: one
    all-gather of a tensor on ``device`` (the group's backend moves
    it)."""
    x = torch.tensor(values, dtype=torch.float64, device=device)
    out = x.new_empty((dist.get_world_size(group) * len(values),))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view(-1, len(values)).cpu().numpy()


# --------------------------------------------------------------------- #
# Placement policies
# --------------------------------------------------------------------- #
class PlacementPolicy:
    """Chooses the replica for each newly registered tenant.

    ``place`` returns a replica index in ``[0, svc.n_replicas)``; the
    service then searches that replica's slot block across the group
    list and opens a new group only when the block is full everywhere.
    ``RoundRobinPlacement``'s cursor is not persisted: after a restore
    placement starts fresh, which only affects future registrations.
    """

    name = "base"

    def place(self, svc: "ShardedSearchService", signature) -> int:
        raise NotImplementedError


class RoundRobinPlacement(PlacementPolicy):
    """Cycle through replicas in registration order."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def place(self, svc, signature):
        r = self._next % svc.n_replicas
        self._next += 1
        return r


class LoadBalancedPlacement(PlacementPolicy):
    """Prefer the replica with the least overflow pressure, breaking
    ties by live tenant count then index.  Pressure is the cumulative
    dropped-append counter summed over the replica's slot block (one
    host read per live group and replica — admission time, not per
    tick)."""

    name = "load_balanced"

    def place(self, svc, signature):
        pressure = svc.replica_pressure()
        load = svc.replica_load()
        return min(range(svc.n_replicas),
                   key=lambda r: (pressure[r], load[r], r))


_PLACEMENTS = {
    RoundRobinPlacement.name: RoundRobinPlacement,
    LoadBalancedPlacement.name: LoadBalancedPlacement,
}


def _resolve_placement(spec) -> PlacementPolicy:
    if spec is None:
        return RoundRobinPlacement()
    if isinstance(spec, PlacementPolicy):
        return spec
    try:
        return _PLACEMENTS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown placement policy {spec!r} "
            f"(known: {sorted(_PLACEMENTS)})") from None


def _visible_cuda_devices() -> tuple:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices=('cpu',) * n_replicas (or "
            "device='cpu') to run the replicas on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


# --------------------------------------------------------------------- #
# The sharded service
# --------------------------------------------------------------------- #
class ShardedSearchService(ContinuousSearchService):
    """``ContinuousSearchService`` with the slot axis split over replicas.

    Same API and per-tenant semantics as the single-device service
    (held to the JAX single-device service in tests/test_torch_mesh.py);
    ``slots_per_group`` is ``n_replicas * slots_per_replica`` and
    placement routes every registration to one replica's slot block.

    ``devices`` is the mesh: one device per replica, repeats allowed
    (``None``: every visible CUDA device — it raises without a card).
    ``device=`` (the base service's keyword) puts every replica on that
    one device.  ``n_replicas`` defaults to ``len(devices)``.
    Checkpoints are written as per-replica npz shards;
    ``restore(..., n_replicas=R')`` repacks onto another replica count.

    ``group`` (keyword-only) runs the service over a ``torch.
    distributed`` process group, every rank constructing it and calling
    it alike (see the module docstring): ``n_replicas`` must divide by
    the group's size, and this rank holds replicas ``local``.
    ``state(qid)`` and ``matches(qid)`` answer for the tenants of this
    rank.
    """

    _MESH_SERVICE = True        # restore-dispatch marker (service.py)

    def __init__(
        self,
        n_replicas: int | None = None,
        slots_per_replica: int | None = None,
        placement=None,
        mesh: dict | None = None,
        *,
        devices=None,
        group=None,
        **kw,
    ):
        # ``mesh`` is the manifest-config form (restore round trip);
        # explicit arguments take precedence over it
        if mesh is not None:
            if n_replicas is None:
                n_replicas = mesh.get("n_replicas")
            if slots_per_replica is None:
                slots_per_replica = mesh.get("slots_per_replica")
            if placement is None:
                placement = mesh.get("placement")
        device = kw.pop("device", None)
        if devices is None:
            devices = (_visible_cuda_devices() if device is None else
                       (device,) * (1 if n_replicas is None
                                    else int(n_replicas)))
        elif device is not None:
            raise ValueError("pass devices= (one per replica) or device= "
                             "(every replica on it), not both")
        devices = tuple(_mesh_device(d) for d in devices)
        if n_replicas is None:
            n_replicas = len(devices)
        if slots_per_replica is None:
            slots_per_replica = 4
        if not 1 <= n_replicas <= len(devices):
            raise ValueError(
                f"n_replicas={n_replicas} needs that many devices (have "
                f"{len(devices)}: {[str(d) for d in devices]}; pass "
                f"devices= with one entry per replica — a device may "
                f"repeat)")
        if len({d.type for d in devices[:n_replicas]}) != 1:
            raise ValueError(f"the replicas' devices mix device types: "
                             f"{[str(d) for d in devices[:n_replicas]]}")
        kw.pop("slots_per_group", None)   # derived, not configurable
        self.n_replicas = int(n_replicas)
        self.slots_per_replica = int(slots_per_replica)
        self.placement = _resolve_placement(placement)
        self.mesh = devices[:self.n_replicas]
        self.group = group
        lo, hi = 0, self.n_replicas
        if group is not None:
            world = dist.get_world_size(group)
            if self.n_replicas % world:
                raise ValueError(f"n_replicas={self.n_replicas} does not "
                                 f"split over a group of {world} ranks")
            per = self.n_replicas // world
            lo = dist.get_rank(group) * per
            hi = lo + per
        self.local = range(lo, hi)          # the replicas this rank holds
        self._distinct = tuple(dict.fromkeys(self.mesh[lo:hi]))
        self.mesh_stats: dict[int, MeshTickStats] = {}  # gid -> last tick
        super().__init__(
            slots_per_group=self.n_replicas * self.slots_per_replica,
            device=self.mesh[lo], **kw)

    # -------------------------------------------------------------- #
    # placement
    # -------------------------------------------------------------- #
    def replica_load(self) -> list[int]:
        """Live tenants per replica (host bookkeeping, no device read)."""
        load = [0] * self.n_replicas
        for _, k in self._location.values():
            load[k // self.slots_per_replica] += 1
        return load

    def replica_pressure(self) -> list[int]:
        """Cumulative dropped appends per replica, summed over every
        live group's slot block (slot-table counters only — shared
        prefix-chain drops are not replica-attributable).  Over a group
        the ranks' counts are all-reduced, so every rank places alike."""
        pressure = self._local_pressure()
        if self.group is not None:
            pressure = [int(x) for x in _gather_host(
                pressure, self.group, self.device).sum(axis=0)]
        return pressure

    def _local_pressure(self) -> list[int]:
        """``replica_pressure`` of the replicas this rank holds (0 for
        the others), without a collective."""
        pressure = [0] * self.n_replicas
        for g in self._iter_groups():
            if g.idle:
                continue
            for r in self.local:
                pressure[r] += int(
                    g.sstate[r].engines.stats.n_overflow.sum())
        return pressure

    def _slot_overflow(self, live) -> int:
        # over a group each rank holds its own blocks: summed over the
        # ranks (the forest's chains, the same on every rank, are not)
        mine = super()._slot_overflow(live)
        if self.group is None:
            return mine
        return int(_gather_host([mine], self.group, self.device).sum())

    def _place(self, groups, plan, leaf, signature):
        r = self.placement.place(self, signature)
        spr = self.slots_per_replica
        for g in groups:
            k = g.free_slot(r * spr, (r + 1) * spr)
            if k is not None:
                return g, k
        g = self._new_group(plan, leaf)
        groups.append(g)
        return g, r * spr

    # -------------------------------------------------------------- #
    # groups / ticking
    # -------------------------------------------------------------- #
    def _new_group(self, template: ExecutionPlan, leaf=None) -> _Group:
        depth = 0 if leaf is None else leaf.depth
        before = self.tick_cache.n_builds
        tick = self.tick_cache.get_mesh(
            template, self.mesh[self.local.start:self.local.stop],
            self.slots_per_replica, backend=self.backend,
            extract_matches=self.extract_matches, max_out=self.max_out,
            prefix_depth=depth, group=self.group)
        self.n_compiles += self.tick_cache.n_builds - before
        g = _Group(
            gid=self._next_gid,
            template=template,
            tick=tick,
            sstate=tuple(init_slot_state(template, self.slots_per_replica,
                                         depth, device=d)
                         if r in self.local else None
                         for r, d in enumerate(self.mesh)),
            empty=init_state(template, depth, device=self.device),
            qids=[None] * self.slots_per_group,
            prefix=leaf,
            spr=self.slots_per_replica,
        )
        self._next_gid += 1
        return g

    def _shard_state(self, sstate: SlotState) -> tuple:
        """Split a SlotState of this rank's slot axis (every slot without
        a group; host or device leaves) into the per-replica blocks,
        block ``r`` on ``mesh[r]``, None for another rank's."""
        spr, first = self.slots_per_replica, self.local.start
        return tuple(
            map_state(lambda x, lo=(r - first) * spr, d=d: torch.as_tensor(
                x[lo:lo + spr], device=d), sstate)
            if r in self.local else None
            for r, d in enumerate(self.mesh))

    def _group_tree(self, g: _Group):
        # this rank's slot axis on the host, one copy per replica block
        return map_state(
            lambda *xs: np.concatenate([x.detach().cpu().numpy()
                                        for x in xs]), *g.blocks())

    def _restore_arrays(self, ckpt_dir, step, like):
        if self.group is None:
            return super()._restore_arrays(ckpt_dir, step, like)
        # this rank's rows of every slot-axis key, the forest whole
        world = len(self.mesh) // len(self.local)
        mesh = make_mesh((world,), ("replica",),
                         devices=(self.device,) * world, group=self.group)
        specs = {k: map_state(
            lambda x, k=k: P("replica") if x.ndim and
            not k.startswith("prefix") else P(), v)
            for k, v in like.items()}
        return restore_checkpoint(ckpt_dir, step, like, mesh=mesh,
                                  specs=specs)

    def _result_slots(self, g: _Group):
        first = self.local.start * self.slots_per_replica
        last = self.local.stop * self.slots_per_replica
        return [(k - first, q) for k, q in enumerate(g.qids)
                if q is not None and first <= k < last]

    def _agree_tick(self, lat_ms: float, tick_overflow: int):
        if self.group is None:
            return lat_ms, tick_overflow
        every = _gather_host([lat_ms, tick_overflow], self.group,
                             self.device)
        return float(every[:, 0].max()), int(every[:, 1].sum())

    def _set_group_state(self, g: _Group, sstate) -> None:
        g.sstate = self._shard_state(sstate)

    def _barrier(self) -> None:
        for d in self._distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _advance_group(self, g: _Group, batch, views=None, forest_nds=None,
                       watermark=None):
        # the base class's flow, with the mesh tick's third output kept
        # per group for observability
        lo, hi = self.local.start, self.local.stop
        blocks = g.sstate[lo:hi]
        if g.prefix is not None:
            blocks, res, mstats = g.tick(
                blocks, batch, views[g.prefix.pid], watermark)
            chain_nd = self.forest.chain_tick_overflow(g.prefix, forest_nds)
            active = [b.params.active for b in blocks]
            active = active[0] if len(active) == 1 else torch.cat(
                [a.to(self.device, non_blocking=True) for a in active])
            res = res._replace(
                n_overflow=res.n_overflow + torch.where(
                    active, chain_nd, torch.zeros_like(chain_nd)))
        else:
            blocks, res, mstats = g.tick(blocks, batch, watermark)
        g.sstate = g.sstate[:lo] + tuple(blocks) + g.sstate[hi:]
        self.mesh_stats[g.gid] = mstats
        return res

    def state(self, qid: int):
        group, k = self._location[qid]
        if group.slot(k)[0] is None:
            raise ValueError(f"tenant {qid} is held by another rank "
                             f"(replica {k // self.slots_per_replica})")
        return super().state(qid)

    def last_mesh_stats(self) -> dict[int, dict]:
        """Host values of every group's last-tick ``MeshTickStats``."""
        return {gid: {"n_matches": int(s.n_matches),
                      "n_overflow": int(s.n_overflow),
                      "t_clock": int(s.t_clock)}
                for gid, s in self.mesh_stats.items()}

    def _register_obs_gauges(self) -> None:
        super()._register_obs_gauges()
        obs = self.obs
        obs.gauge("mesh.n_replicas").set(self.n_replicas)
        obs.register_gauge(
            "mesh.replica_load_max", lambda: max(self.replica_load(),
                                                 default=0))
        obs.register_gauge(
            "mesh.replica_pressure_max",
            lambda: max(self._local_pressure(), default=0))

    def _trace_tick_extras(self, tr) -> None:
        # after the barrier: reading the scalars adds no sync point
        for gid, s in self.last_mesh_stats().items():
            tr.event("mesh.collectives", gid=gid, **s)

    # -------------------------------------------------------------- #
    # checkpoint / restore
    # -------------------------------------------------------------- #
    def _replica_refcounts(self) -> dict:
        spr = self.slots_per_replica
        assignments = [(leaf, self._location[qid][1] // spr)
                       for qid, leaf in self._prefix_of.items()]
        return {str(pid): counts
                for pid, counts in self.forest.replica_refcounts(
                    assignments, self.n_replicas).items()}

    def _manifest(self) -> dict:
        man = super()._manifest()
        cfg = man["config"]
        del cfg["slots_per_group"]      # derived from the mesh config
        cfg["mesh"] = {
            "n_replicas": self.n_replicas,
            "slots_per_replica": self.slots_per_replica,
            "placement": self.placement.name,
        }
        if self.forest is not None:
            man["replica_refcounts"] = self._replica_refcounts()
        return man

    def _ckpt_save_kwargs(self) -> dict:
        # slot-stacked group states split along axis 0 into one npz per
        # replica; forest node tables (replicated inputs) and scalars
        # ride in shard 0
        replicated = ()
        if self.forest is not None:
            replicated = tuple(
                f"prefix{n.pid}" for n in self.forest.nodes())
        return {"n_shards": self.n_replicas, "replicated": replicated,
                "group": self.group}

    @classmethod
    def restore(
        cls,
        ckpt_dir: str,
        step: int | None = None,
        tick_cache: SlotTickCache | None = None,
        backend: str | None = None,
        extract_matches: bool | None = None,
        n_replicas: int | None = None,
        placement=None,
        obs=None,
        tracer=None,
        *,
        devices=None,
        device=None,
        group=None,
    ) -> "ShardedSearchService":
        """Rebuild a sharded service from its newest usable checkpoint.

        With ``n_replicas`` equal to the checkpointed replica count (or
        omitted) the exact slot layout is re-armed — zero builds for
        meshes this process has served.  A different ``n_replicas``
        takes the repack path: queries keep their qids, the placement
        policy re-places every tenant, and each tenant's engine rows are
        spliced from its old slot into its new one (the shards are
        reassembled on the host, so the files do not depend on the
        mesh).  ``devices`` / ``device`` / ``group`` place the replicas
        as the constructor does: over a group every rank calls it, reads
        its own replicas' rows (the repack path reads the whole old
        layout on each rank) and re-places alike.
        """
        overrides = {}
        if backend is not None:
            overrides["backend"] = backend
        if extract_matches is not None:
            overrides["extract_matches"] = extract_matches
        if placement is not None:
            overrides["placement"] = placement
        if obs is not None:
            overrides["obs"] = obs
        if tracer is not None:
            overrides["tracer"] = tracer
        if devices is not None:
            overrides["devices"] = devices
        if group is not None:
            overrides["group"] = group
        candidates = ([step] if step is not None
                      else list(reversed(checkpoint_steps(ckpt_dir))))
        last_err: CheckpointError | None = None
        for s in candidates:
            try:
                validate_checkpoint(ckpt_dir, s)
                man = load_resolved_manifest(ckpt_dir, s, "service")
                mesh_cfg = man["config"].get("mesh")
                if mesh_cfg is None:
                    raise CheckpointError(
                        f"step {s}: not a ShardedSearchService checkpoint")
                if (n_replicas is None
                        or n_replicas == mesh_cfg["n_replicas"]):
                    return cls._restore_step(ckpt_dir, s, tick_cache,
                                             overrides, device)
                return cls._restore_reshard(ckpt_dir, s, man, tick_cache,
                                            overrides, n_replicas, device)
            except CheckpointError as e:
                last_err = e
        raise CheckpointError(
            f"no usable sharded checkpoint under {ckpt_dir!r}"
        ) from last_err

    @classmethod
    def _restore_step(cls, ckpt_dir, step, tick_cache, overrides, device):
        svc = super()._restore_step(ckpt_dir, step, tick_cache, overrides,
                                    device)
        svc._verify_replica_refcounts(
            load_resolved_manifest(ckpt_dir, step, "service"), step)
        return svc

    def _verify_replica_refcounts(self, man, step) -> None:
        """Refcounts are rebuilt, not trusted: re-derive the per-replica
        partition from the restored slot layout and compare with what
        the manifest recorded."""
        want = man.get("replica_refcounts")
        if want is None or self.forest is None:
            return
        got = self._replica_refcounts()
        if want != got:
            raise CheckpointError(
                f"step {step}: per-replica refcount partition disagrees "
                f"with the manifest (manifest {want}, rebuilt {got})")

    @classmethod
    def _restore_reshard(cls, ckpt_dir, step, man, tick_cache, overrides,
                         n_replicas, device):
        """Restore onto another replica count: re-place and splice."""
        config = _restore_config(man, overrides, step)
        mesh_cfg = dict(config.pop("mesh"))
        mesh_cfg["n_replicas"] = n_replicas
        svc = cls(ckpt_dir=ckpt_dir, tick_cache=tick_cache, mesh=mesh_cfg,
                  device=device, **{**config, **overrides})
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

        # the old layout: one whole-slot-axis SlotState per old group,
        # restored on the host
        groups = sorted(man["groups"].items(), key=lambda kv: int(kv[0]))
        like, leaves = {}, {}
        for gid_s, gspec in groups:
            template = svc.registry.compile(
                QueryGraph.from_spec(gspec["template_query"]),
                int(gspec["template_window"]),
                decomposition=gspec.get("template_decomposition"))
            pid = gspec.get("prefix_pid")
            leaf = None if pid is None else by_pid[int(pid)]
            depth = 0 if leaf is None else leaf.depth
            leaves[gid_s] = leaf
            like[gid_s] = init_slot_state(template, len(gspec["qids"]),
                                          depth, device="cpu")
        if svc.forest is not None and man.get("forest"):
            for n in svc.forest.nodes():
                like[f"prefix{n.pid}"] = n.state
        restored = restore_checkpoint(ckpt_dir, step, like)

        # re-place every tenant and splice its engine rows out of the
        # old slot; params are rewritten from its plan
        for gid_s, gspec in groups:
            old = restored[gid_s].engines
            leaf = leaves[gid_s]
            for k, qid in enumerate(gspec["qids"]):
                if qid is None:
                    continue
                qid = int(qid)
                rq = svc.registry.get(qid)
                gkey = (rq.signature, None if leaf is None else leaf.pid)
                gs = svc._groups.setdefault(gkey, [])
                group, k2 = svc._place(gs, rq.plan, leaf, rq.signature)
                block, row = group.slot(k2)
                if block is not None:
                    write_slot(block, group.template, row, rq.plan,
                               empty=group.empty)
                    map_state(lambda full, o, row=row, k=k:
                              full[row].copy_(o[k]), block.engines, old)
                group.qids[k2] = qid
                svc._location[qid] = (group, k2)
                if leaf is not None:
                    svc._prefix_of[qid] = svc.forest.adopt(leaf)
        if svc.forest is not None and man.get("forest"):
            want = {int(e["pid"]): int(e["refcount"])
                    for e in man["forest"]["nodes"]}
            got = {n.pid: n.refcount for n in svc.forest.nodes()}
            if want != got:
                raise CheckpointError(
                    f"step {step}: forest refcounts disagree with the "
                    f"manifest after repack (manifest {want}, "
                    f"rebuilt {got})")
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
