"""Cross-tenant prefix sharing: the ``SharedPrefixForest`` subsystem.

The engine answers each standing query by maintaining expansion lists
for its TC-subqueries; concurrent tenants overlap heavily in the
*prefixes* of those lists (the multi-query observation of StreamWorks /
PNNL's large-scale continuous subgraph queries — see PAPERS.md).  Until
now every tenant materialized and advanced its own tables, sharing only
the label-match phase and compiled XLA ticks.  This module adds
common-subexpression elimination across tenants at the TABLE level:

* ``prefix_chain(plan)`` slices subquery 0's timing sequence into its
  depth-1..m prefixes and keys each by ``canonical_key`` of the chain-
  renumbered prefix query (``repro_torch.core.canon``) plus the window span —
  label-renamed / vertex-relabeled tenants hash to the SAME signature.
  Because a timing sequence is a ≺-chain, the chain renumbering (vertex
  ids by first appearance, edge ids by chain position) is *forced* by
  the isomorphism, so equal signatures imply literally identical prefix
  queries — and therefore bit-identical expansion-list tables.

* ``SharedPrefixForest`` is a refcounted trie of ``PrefixNode``s: one
  ``LevelTable`` per (prefix signature, epoch), advanced ONCE per tick
  by a dedicated prefix tick in depth order.  A tenant acquires the
  whole chain for its subquery 0 and its slot tick consumes the leaf's
  per-tick ``NodeView`` (``build_tick_body(prefix_depth=...)``), running
  only the suffix joins.  Partial overlap shares partially: a 3-chain
  tenant and a 2-chain tenant alias the depth-1/2 nodes and diverge at
  depth 3.

* *Epochs* keep per-tenant registration-time semantics exact: a node
  created at stream offset ``o`` contains precisely the partial matches
  a tenant registered at ``o`` would have built alone, so only tenants
  registered at the same offset may alias it.  This is what makes the
  sharing-enabled engine oracle-multiset-exact under churn — a tenant
  arriving mid-stream gets fresh nodes instead of inheriting history.

Node ticks are structural (labels and window are runtime inputs), so
they live in the process-wide ``SlotTickCache`` next to the slot ticks:
restore-after-crash re-arms the forest with cache hits, zero warm
rebuilds.

The port of ``repro.core.share``.  A node's table has no slot axis; its
tick joins the parent's view against the stream batch through
``core.join.join_pairs`` at S = 1 (on the card: the hand-written CUDA
pair kernel), and keeps its per-tick overflow on the device — the
service adds it onto each aliasing tenant's ``TickResult`` with tensor
adds, never with a host read per node.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import join as J
from repro_torch.core.canon import canonical_key
from repro_torch.core.engine import (
    NO_WATERMARK,
    _append_level,
    edge_match_mask,
    fold_level_host,
    matches_from_rows,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph
from repro_torch.core.state import (
    EngineState,
    LevelTable,
    _empty_level,
    map_state,
    resolve_device,
)

I32 = torch.int32


class NodeView(NamedTuple):
    """A prefix node's per-tick export: the denormalized post-append view
    its consumers join against (suffix ticks and child nodes), plus the
    post-expiry validity the consumers cascade deletions from."""

    bind: torch.Tensor         # int32 [C, nv]   pre-expiry, post-append
    ets: torch.Tensor          # int32 [C, ne]
    valid: torch.Tensor        # bool  [C]       pre-expiry
    fresh: torch.Tensor        # bool  [C]       appended this tick
    valid_after: torch.Tensor  # bool  [C]       post-expiry (cascaded)


class NodeState(NamedTuple):
    """Device state of one prefix node: one expansion-list level table."""

    table: LevelTable
    t_now: torch.Tensor        # int32 scalar
    n_overflow: torch.Tensor   # int32 scalar, cumulative dropped appends


class NodeSpec(NamedTuple):
    """Structural identity of a node tick (the SlotTickCache key part).

    ``parent_ne == 0`` marks a root (depth-1) node; labels and window are
    runtime inputs, so one built node tick serves every label/window
    variant of the same structure."""

    parent_nv: int            # prefix layout width at depth-1 (0 at root)
    parent_ne: int            # = depth - 1
    src_slot: int             # this edge's src slot in the parent layout
    dst_slot: int             # (-1 = new vertex)
    capacity: int
    max_new: int


class SharedPrefixInfo(NamedTuple):
    """Per-tenant sharing stats (``Subscription.shared_prefix``)."""

    depth: int                # externalized levels of subquery 0
    n_tenants: int            # tenants aliasing this tenant's leaf node
    epoch: int                # stream offset the node chain started at


class ForestStats(NamedTuple):
    n_nodes: int              # live prefix tables
    n_shared_nodes: int       # nodes aliased by more than one tenant
    n_tenants: int            # acquired (live) tenant handles
    table_bytes: int          # device bytes held by all node tables


class PrefixChain(NamedTuple):
    """Host-side description of a plan's shareable prefixes."""

    sigs: tuple               # per-depth signature (canonical_key, window)
    queries: tuple            # per-depth chain-renumbered QueryGraph
    depth: int                # = len(subquery 0 timing sequence)


def prefix_chain(plan: ExecutionPlan) -> PrefixChain:
    """Slice subquery 0's timing sequence into canonical prefixes.

    The depth-``j`` prefix query renumbers vertices by first appearance
    and edges by chain position with the chain precedence — a forced
    renumbering, so isomorphic prefixes produce *identical* graphs; the
    signature still goes through ``canonical_key`` so the dedup contract
    is exactly the planner's isomorphism-class identity.
    """
    q = plan.query
    seq = plan.subqueries[0].timing_sequence
    vmap: dict[int, int] = {}
    edges: list[tuple[int, int]] = []
    vlabels: list[int] = []
    elabels: list[int] = []
    sigs, queries = [], []
    for j, eid in enumerate(seq):
        u, v = q.edges[eid]
        for x in (u, v):
            if x not in vmap:
                vmap[x] = len(vmap)
                vlabels.append(q.vertex_labels[x])
        edges.append((vmap[u], vmap[v]))
        elabels.append(q.edge_labels[eid])
        pq = QueryGraph(
            n_vertices=len(vmap),
            vertex_labels=tuple(vlabels),
            edges=tuple(edges),
            edge_labels=tuple(elabels),
            prec=frozenset((i, i + 1) for i in range(j)),
        )
        queries.append(pq)
        sigs.append((canonical_key(pq), int(plan.window)))
    return PrefixChain(tuple(sigs), tuple(queries), len(seq))


def node_spec(plan: ExecutionPlan, j: int) -> NodeSpec:
    """Structural spec of the depth-``j+1`` node of ``plan``'s chain.
    Equal across every tenant sharing the depth-``j+1`` signature (the
    layout slot positions are forced by the chain renumbering)."""
    s0 = plan.subqueries[0]
    lv = s0.levels[j]
    return NodeSpec(
        parent_nv=len(s0.levels[j - 1].vertex_layout) if j else 0,
        parent_ne=j,
        src_slot=lv.src_slot,
        dst_slot=lv.dst_slot,
        capacity=lv.capacity,
        max_new=lv.max_new,
    )


def init_node_state(spec: NodeSpec, *, device=None) -> NodeState:
    """Empty node state on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return NodeState(table=_empty_level(spec.capacity, device),
                     t_now=torch.zeros((), dtype=I32, device=device),
                     n_overflow=torch.zeros((), dtype=I32, device=device))


def _append(table: LevelTable, parent_idx, src, dst, ts, req_valid):
    """``engine._append_level`` on an unbatched table (S = 1)."""
    t, nd = _append_level(map_state(lambda x: x[None], table), parent_idx,
                          src, dst, ts, req_valid[None])
    return map_state(lambda x: x[0], t), nd[0]


def build_node_tick(spec: NodeSpec, backend: str = J.JoinBackend.REF):
    """Build the per-tick advance of one prefix node.

    Root:   ``tick(state, batch, esl, edl, eel, window, watermark=None)``
    Child:  ``tick(state, batch, parent_view, esl, edl, eel, window,
    watermark=None)``

    Both return ``(state, NodeView, n_overflow_this_tick)``, all on the
    device.  The label scalars and the window are runtime inputs (int32
    0-dim tensors), so one built tick serves every same-structure node.
    Semantics mirror one level of ``build_tick_body`` exactly: append
    against the parent's post-append view, export the pre-expiry view,
    expire at end of tick with the cascade from the parent's post-expiry
    validity.  The child's join is ``join_pairs`` at S = 1 — the CUDA
    pair kernel under ``JoinBackend.CUDA``.
    """

    def _advance_time(state, batch, window, watermark):
        # event-time mode: reject at-or-below the already-released floor
        # before the clock moves, then advance to min(watermark, max batch
        # ts) — the clock rule of ``build_tick_body``, so a shared prefix
        # table expires in lockstep with its tenants' suffix tables
        valid = batch.valid
        if watermark is not None:
            late = valid & (batch.ts <= state.t_now - window)
            valid = valid & ~late
            batch = batch._replace(valid=valid)
        bt = torch.where(valid, batch.ts,
                         torch.full_like(batch.ts, NO_WATERMARK))
        bt_max = bt.max()
        if watermark is None:
            t_now = torch.maximum(state.t_now, bt_max)
        else:
            wm = torch.as_tensor(watermark, dtype=I32,
                                 device=state.t_now.device)
            t_now = torch.maximum(state.t_now, torch.minimum(wm, bt_max))
        table = state.table._replace(
            fresh=torch.zeros_like(state.table.fresh))
        return t_now, table, batch

    def _match(batch, esl, edl, eel):
        return edge_match_mask(batch, esl[None], edl[None], eel[None])[0]

    if spec.parent_ne == 0:                      # depth-1 root
        def tick(state: NodeState, batch, esl, edl, eel, window,
                 watermark=None):
            t_now, table, batch = _advance_time(state, batch, window,
                                                watermark)
            em = _match(batch, esl, edl, eel)
            table, nd = _append(
                table, torch.full_like(batch.src, -1),
                batch.src, batch.dst, batch.ts, em)
            bind = torch.stack([table.src, table.dst], dim=1)
            ets = table.ts[:, None]
            valid_after = table.valid & (table.ts > t_now - window)
            view = NodeView(bind, ets, table.valid, table.fresh, valid_after)
            return (NodeState(table._replace(valid=valid_after), t_now,
                              state.n_overflow + nd), view, nd)
        return tick

    rel = np.zeros((spec.parent_nv, 2), dtype=bool)
    if spec.src_slot >= 0:
        rel[spec.src_slot, 0] = True
    if spec.dst_slot >= 0:
        rel[spec.dst_slot, 1] = True
    trel = np.zeros((spec.parent_ne, 1), dtype=np.int8)
    trel[-1, 0] = -1                             # ≺-chain: last edge only

    def tick(state: NodeState, batch, parent: NodeView, esl, edl, eel,
             window, watermark=None):
        t_now, table, batch = _advance_time(state, batch, window, watermark)
        em = _match(batch, esl, edl, eel)
        bbind = torch.stack([batch.src, batch.dst], dim=1)
        bets = batch.ts[:, None]
        # the parent's table as a stack of one slot against the shared
        # batch: the single-query (S = 1) form of the pair join
        a_idx, b_idx, pv, nd1 = J.join_pairs(
            parent.bind[None], parent.ets[None], parent.valid[None],
            bbind, bets, em[None], rel, trel, spec.max_new,
            window.reshape(1), backend)
        b_idx = b_idx[0].clamp(0, batch.src.shape[0] - 1)   # take(clip)
        table, nd2 = _append(table, a_idx[0], batch.src[b_idx],
                             batch.dst[b_idx], batch.ts[b_idx], pv[0])
        p = table.parent.clamp(0, parent.bind.shape[0] - 1).long()
        own = []
        if spec.src_slot < 0:
            own.append(table.src[:, None])
        if spec.dst_slot < 0:
            own.append(table.dst[:, None])
        bind = torch.cat([parent.bind[p]] + own, dim=1)
        ets = torch.cat([parent.ets[p], table.ts[:, None]], dim=1)
        valid_after = (table.valid & (table.ts > t_now - window)
                       & parent.valid_after[p])
        view = NodeView(bind, ets, table.valid, table.fresh, valid_after)
        nd = nd1[0] + nd2
        return (NodeState(table._replace(valid=valid_after), t_now,
                          state.n_overflow + nd), view, nd)
    return tick


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclass(eq=False)
class PrefixNode:
    """One refcounted prefix table in the forest trie."""

    pid: int                           # stable id (checkpoint manifest key)
    depth: int                         # 1-based chain length
    sig: tuple                         # (canonical_key(prefix), window)
    epoch: int                         # stream offset at creation
    parent: "PrefixNode | None"
    spec: NodeSpec
    query: QueryGraph                  # chain-renumbered prefix query
    esl: torch.Tensor                  # int32 scalars: this edge's labels
    edl: torch.Tensor
    eel: torch.Tensor
    window: torch.Tensor               # int32 scalar
    tick: object                       # SlotTickCache-shared node tick
    state: NodeState
    refcount: int = 0

    @property
    def table_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in _leaves(self.state))


class SharedPrefixForest:
    """Refcounted registry of shared prefix tables, advanced once per
    tick.  Owned by one ``ContinuousSearchService``; node ticks come from
    the (usually process-wide) ``SlotTickCache``."""

    def __init__(self, tick_cache, backend: str = J.JoinBackend.REF, *,
                 device=None):
        self.tick_cache = tick_cache
        self.backend = backend
        self.device = resolve_device(device)
        self._by_key: dict[tuple, PrefixNode] = {}   # (sig, epoch) -> node
        self._next_pid = 0
        self._n_handles = 0

    def __len__(self) -> int:
        return len(self._by_key)

    def nodes(self) -> list[PrefixNode]:
        return sorted(self._by_key.values(), key=lambda n: n.pid)

    def states(self) -> list[NodeState]:
        return [n.state for n in self.nodes()]

    # ------------------------------------------------------------------ #
    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(int(v), dtype=I32, device=self.device)

    def _make_node(self, pid, depth, sig, epoch, parent, spec, query,
                   labels, window) -> PrefixNode:
        esl, edl, eel = labels
        return PrefixNode(
            pid=pid, depth=depth, sig=sig, epoch=epoch, parent=parent,
            spec=spec, query=query,
            esl=self._scalar(esl), edl=self._scalar(edl),
            eel=self._scalar(eel), window=self._scalar(window),
            tick=self.tick_cache.get_node(spec, backend=self.backend),
            state=init_node_state(spec, device=self.device),
        )

    def _new_node(self, plan: ExecutionPlan, j: int, sig: tuple,
                  query: QueryGraph, epoch: int,
                  parent: PrefixNode | None) -> PrefixNode:
        eid = plan.subqueries[0].timing_sequence[j]
        node = self._make_node(
            self._next_pid, j + 1, sig, epoch, parent, node_spec(plan, j),
            query, (plan.edge_src_label[eid], plan.edge_dst_label[eid],
                    plan.edge_edge_label[eid]), plan.window)
        self._next_pid += 1
        return node

    def acquire(self, plan: ExecutionPlan, epoch: int) -> PrefixNode:
        """Acquire the whole prefix chain of ``plan``'s subquery 0 at
        ``epoch``; returns the leaf node (depth = full subquery 0).
        Every node along the chain gains one reference; on failure
        nothing is retained, so a raising acquire never orphans tables."""
        chain = prefix_chain(plan)
        parent = None
        try:
            for j in range(chain.depth):
                key = (chain.sigs[j], epoch)
                node = self._by_key.get(key)
                if node is None:
                    node = self._new_node(plan, j, chain.sigs[j],
                                          chain.queries[j], epoch, parent)
                    self._by_key[key] = node
                elif node.spec != node_spec(plan, j):
                    # unreachable by the chain-renumbering argument; loud
                    # beats a silently corrupt shared table
                    raise ValueError(
                        f"prefix signature collision at depth {j + 1}: "
                        f"{node.spec} vs {node_spec(plan, j)}")
                node.refcount += 1
                parent = node
        except Exception:
            node = parent
            while node is not None:       # roll back the partial chain
                node.refcount -= 1
                if node.refcount == 0:
                    del self._by_key[(node.sig, node.epoch)]
                node = node.parent
            raise
        self._n_handles += 1
        return parent

    def release(self, leaf: PrefixNode) -> None:
        """Release one tenant's chain; nodes dropping to zero references
        are freed (deepest first)."""
        node = leaf
        while node is not None:
            node.refcount -= 1
            if node.refcount == 0:
                del self._by_key[(node.sig, node.epoch)]
            node = node.parent
        self._n_handles -= 1

    def adopt(self, leaf: PrefixNode) -> PrefixNode:
        """Re-reference an existing chain (checkpoint-restore path: the
        nodes already exist with refcount 0)."""
        node = leaf
        while node is not None:
            node.refcount += 1
            node = node.parent
        self._n_handles += 1
        return leaf

    # ------------------------------------------------------------------ #
    def advance(self, batch, watermark=None):
        """One dedicated prefix tick: advance every node once, in depth
        order (parents before children).  Returns the per-node views and
        the per-node overflow scalars keyed by pid (device tensors; the
        service attributes each tenant's chain overflow onto its
        ``TickResult``).  ``watermark`` selects the same clock mode the
        tenants' slot ticks run under."""
        views: dict[int, NodeView] = {}
        nds: dict[int, torch.Tensor] = {}
        for node in sorted(self._by_key.values(),
                           key=lambda n: (n.depth, n.pid)):
            if node.parent is None:
                node.state, view, nd = node.tick(
                    node.state, batch, node.esl, node.edl, node.eel,
                    node.window, watermark)
            else:
                node.state, view, nd = node.tick(
                    node.state, batch, views[node.parent.pid],
                    node.esl, node.edl, node.eel, node.window, watermark)
            views[node.pid] = view
            nds[node.pid] = nd
        return views, nds

    @staticmethod
    def chain_tick_overflow(leaf: PrefixNode, nds: dict):
        """This tick's dropped appends along ``leaf``'s chain (a device
        scalar) — what each aliasing tenant's own prefix tables would
        have dropped in an unshared run."""
        total, node = 0, leaf
        while node is not None:
            total = total + nds[node.pid]
            node = node.parent
        return total

    def replica_refcounts(self, assignments, n_replicas: int) -> dict:
        """Per-replica partition of the forest's refcounts.

        Under mesh serving (``repro_torch.runtime.mesh``) node tables are
        replicated — every replica's joins read the same view — but each
        aliasing tenant lives on exactly one replica, so every node's
        refcount partitions by placement.  ``assignments`` is an
        iterable of ``(leaf, replica)`` pairs, one per live tenant;
        returns ``{pid: [count per replica]}`` with ``sum(counts) ==
        node.refcount`` (the mesh checkpoint manifest records it and
        restore verifies it)."""
        out: dict[int, list[int]] = {}
        for leaf, r in assignments:
            node = leaf
            while node is not None:
                counts = out.setdefault(node.pid, [0] * n_replicas)
                counts[r] += 1
                node = node.parent
        return out

    def chain_overflow(self, leaf: PrefixNode) -> int:
        """Cumulative dropped appends along one tenant's chain (host
        reads: status time, not the tick)."""
        total, node = 0, leaf
        while node is not None:
            total += int(node.state.n_overflow)
            node = node.parent
        return total

    def total_overflow(self) -> int:
        """Dropped appends summed over every node (host reads)."""
        return sum(int(n.state.n_overflow) for n in self._by_key.values())

    def stats(self) -> ForestStats:
        nodes = list(self._by_key.values())
        return ForestStats(
            n_nodes=len(nodes),
            n_shared_nodes=sum(1 for n in nodes if n.refcount > 1),
            n_tenants=self._n_handles,
            table_bytes=sum(n.table_bytes for n in nodes),
        )

    def register_obs(self, obs) -> None:
        """Expose forest shape under ``share.*`` as collect-time callback
        gauges on a ``repro_torch.obs.MetricsRegistry`` — evaluated only
        at snapshot time, never on the serve loop."""
        obs.register_gauge("share.n_nodes", lambda: self.stats().n_nodes)
        obs.register_gauge("share.n_shared_nodes",
                           lambda: self.stats().n_shared_nodes)
        obs.register_gauge("share.n_tenants",
                           lambda: self.stats().n_tenants)
        obs.register_gauge("share.table_bytes",
                           lambda: self.stats().table_bytes)

    # ------------------------------------------------------------------ #
    # checkpoint / restore
    # ------------------------------------------------------------------ #
    def to_manifest(self) -> dict:
        return {
            "next_pid": self._next_pid,
            "nodes": [
                {
                    "pid": n.pid,
                    "depth": n.depth,
                    "epoch": int(n.epoch),
                    "refcount": int(n.refcount),
                    "parent": None if n.parent is None else n.parent.pid,
                    "query": n.query.to_spec(),
                    "window": int(n.window),
                    "spec": list(n.spec),
                    "labels": [int(n.esl), int(n.edl), int(n.eel)],
                }
                for n in self.nodes()
            ],
        }

    def restore_nodes(self, man: dict) -> dict[int, PrefixNode]:
        """Rebuild the trie skeleton from a checkpoint manifest: nodes
        come back with their pids/epochs/signatures, EMPTY state (the
        caller overwrites it from the npz) and refcount 0 (the caller
        re-adopts one chain per restored tenant and checks the counts
        against the manifest)."""
        by_pid: dict[int, PrefixNode] = {}
        for ent in sorted(man["nodes"], key=lambda e: e["depth"]):
            spec = NodeSpec(*ent["spec"])
            query = QueryGraph.from_spec(ent["query"])
            sig = (canonical_key(query), int(ent["window"]))
            parent = None if ent["parent"] is None else by_pid[ent["parent"]]
            node = self._make_node(
                int(ent["pid"]), int(ent["depth"]), sig, int(ent["epoch"]),
                parent, spec, query, ent["labels"], ent["window"])
            self._by_key[(sig, node.epoch)] = node
            by_pid[node.pid] = node
        self._next_pid = max(int(man["next_pid"]),
                             1 + max(by_pid, default=-1))
        return by_pid

    # ------------------------------------------------------------------ #
    # host-side reconstruction (result extraction / tests)
    # ------------------------------------------------------------------ #
    def host_table(self, leaf: PrefixNode):
        """Denormalized (bind, ets, valid) numpy arrays of ``leaf``'s
        table, reconstructed through the parent chain (root-first folds
        of the shared layout rule, ``engine.fold_level_host``)."""
        chain = []
        node = leaf
        while node is not None:
            chain.append(node)
            node = node.parent
        chain.reverse()
        acc = None
        for n in chain:
            acc = fold_level_host(acc, n.state.table,
                                  n.spec.src_slot, n.spec.dst_slot)
        bind, ets = acc
        return bind, ets, chain[-1].state.table.valid.cpu().numpy()


def shared_current_matches(plan: ExecutionPlan, leaf: PrefixNode,
                           forest: SharedPrefixForest,
                           state: EngineState):
    """``engine.current_matches`` for a prefix-shared tenant: fold the
    tenant's suffix levels on top of the shared table's reconstruction.
    Plans with L0 joins keep their denormalized final table locally, so
    those read straight from the suffix state."""
    if plan.l0_joins:
        from repro_torch.core.engine import current_matches
        return current_matches(plan, state)
    s = plan.subqueries[0]
    bind, ets, valid = forest.host_table(leaf)
    for ti, li in enumerate(range(leaf.depth, len(s.levels))):
        lv = s.levels[li]
        t = state.levels[0][ti]
        bind, ets = fold_level_host((bind, ets), t,
                                    lv.src_slot, lv.dst_slot)
        valid = t.valid.cpu().numpy()
    return matches_from_rows(plan, bind, ets, valid)
