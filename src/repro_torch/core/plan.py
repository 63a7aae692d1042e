"""Compile a (query, decomposition, join order) into a numeric ExecutionPlan.

The device engine works over fixed-capacity tables of *partial matches*.
Every join in the system — a new stream edge against expansion-list item
``L_i^{j-1}`` (Algorithm 1 line 8), or a TC-subquery delta against the
global list ``L_0`` (lines 16/20) — is an instance of one generic
compatibility join (Definitions 7/8):

    mask[a, b] = AND over vertex-slot pairs  (EQ where same query vertex,
                                              NEQ otherwise — isomorphism
                                              injectivity)
               & AND over edge-slot pairs    (ts_a < ts_b / ts_a > ts_b
                                              where ≺ relates the edges)

So the plan compiles to, per join site: a boolean REL matrix (same-query-
vertex), an int8 TREL matrix (timing order), and slot layouts describing
which query vertex / query edge each table column holds.

This file is host-side numpy; the tick body closes over the arrays as
constants of its structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.decompose import TCSubquery, decompose, join_order
from repro_torch.core.query import QueryGraph


@dataclass
class LevelSpec:
    """One item ``L_i^j`` of a TC-subquery's expansion list (Definition 11)."""

    qedge: int                      # global query edge id matched at this level
    src_v: int                      # query vertex ids of that edge
    dst_v: int
    src_slot: int                   # slot in the *previous* layout, -1 if new
    dst_slot: int
    new_vertices: tuple[int, ...]   # query vertices first bound at this level
    vertex_layout: tuple[int, ...]  # query vertex id per slot AFTER this level
    capacity: int = 0               # filled by compile_plan
    max_new: int = 0


@dataclass
class SubquerySpec:
    """Expansion list spec for one TC-subquery P_i."""

    timing_sequence: tuple[int, ...]
    levels: list[LevelSpec]

    @property
    def vertex_layout(self) -> tuple[int, ...]:
        return self.levels[-1].vertex_layout

    @property
    def edge_layout(self) -> tuple[int, ...]:
        return self.timing_sequence


@dataclass
class JoinSpec:
    """Generic compatibility-join spec between table A and table B."""

    rel: np.ndarray                     # bool [nvA, nvB]: True = same query vertex
    trel: np.ndarray                    # int8 [neA, neB]: -1 tsA<tsB, +1 tsA>tsB
    b_new_vertex_slots: tuple[int, ...]  # B slots appended to A's layout
    vertex_layout: tuple[int, ...]      # output layout (A ++ new B)
    edge_layout: tuple[int, ...]        # output edge layout (A ++ B)
    capacity: int = 0
    max_new: int = 0


@dataclass
class ExecutionPlan:
    """Everything ``tick()`` needs, as static metadata."""

    query: QueryGraph
    window: int
    subqueries: list[SubquerySpec]
    l0_joins: list[JoinSpec]            # k-1 entries (empty when k == 1)
    # label tables, for the per-batch query-edge match mask:
    edge_src_label: np.ndarray          # int32 [n_qedges]
    edge_dst_label: np.ndarray
    edge_edge_label: np.ndarray         # -1 = wildcard
    # bookkeeping
    decomposition_sizes: tuple[int, ...] = ()
    # mapping query-edge id -> (subquery index, level index)
    edge_site: dict[int, tuple[int, int]] = field(default_factory=dict)

    @property
    def n_subqueries(self) -> int:
        return len(self.subqueries)

    @property
    def final_vertex_layout(self) -> tuple[int, ...]:
        if self.l0_joins:
            return self.l0_joins[-1].vertex_layout
        return self.subqueries[0].vertex_layout

    @property
    def final_edge_layout(self) -> tuple[int, ...]:
        if self.l0_joins:
            return self.l0_joins[-1].edge_layout
        return self.subqueries[0].edge_layout


def _compile_subquery(q: QueryGraph, tc: TCSubquery) -> SubquerySpec:
    levels: list[LevelSpec] = []
    layout: list[int] = []
    for eid in tc.timing_sequence:
        u, v = q.edges[eid]
        src_slot = layout.index(u) if u in layout else -1
        dst_slot = layout.index(v) if v in layout else -1
        new_vs: list[int] = []
        if src_slot < 0:
            new_vs.append(u)
            layout.append(u)
        if dst_slot < 0:
            new_vs.append(v)
            layout.append(v)
        levels.append(
            LevelSpec(
                qedge=eid,
                src_v=u,
                dst_v=v,
                src_slot=src_slot,
                dst_slot=dst_slot,
                new_vertices=tuple(new_vs),
                vertex_layout=tuple(layout),
            )
        )
    return SubquerySpec(timing_sequence=tc.timing_sequence, levels=levels)


def _join_spec(
    q: QueryGraph,
    a_vertex_layout: tuple[int, ...],
    a_edge_layout: tuple[int, ...],
    b_vertex_layout: tuple[int, ...],
    b_edge_layout: tuple[int, ...],
) -> JoinSpec:
    nva, nvb = len(a_vertex_layout), len(b_vertex_layout)
    rel = np.zeros((nva, nvb), dtype=bool)
    for i, va in enumerate(a_vertex_layout):
        for j, vb in enumerate(b_vertex_layout):
            rel[i, j] = va == vb
    nea, neb = len(a_edge_layout), len(b_edge_layout)
    trel = np.zeros((nea, neb), dtype=np.int8)
    for i, ea in enumerate(a_edge_layout):
        for j, eb in enumerate(b_edge_layout):
            if q.precedes(ea, eb):
                trel[i, j] = -1
            elif q.precedes(eb, ea):
                trel[i, j] = 1
    new_slots = tuple(
        j for j, vb in enumerate(b_vertex_layout) if vb not in a_vertex_layout
    )
    out_vlayout = tuple(a_vertex_layout) + tuple(b_vertex_layout[j] for j in new_slots)
    out_elayout = tuple(a_edge_layout) + tuple(b_edge_layout)
    return JoinSpec(
        rel=rel,
        trel=trel,
        b_new_vertex_slots=new_slots,
        vertex_layout=out_vlayout,
        edge_layout=out_elayout,
    )


def compile_plan(
    q: QueryGraph,
    window: int,
    decomposition: list[TCSubquery] | None = None,
    level_capacity: int = 4096,
    l0_capacity: int = 4096,
    max_new: int = 1024,
) -> ExecutionPlan:
    """Compile ``q`` into an ExecutionPlan.

    ``window`` is the sliding-window span |W| in timestamp units.
    ``level_capacity`` / ``l0_capacity`` size the fixed device tables;
    ``max_new`` bounds appends per table per tick (overflow is counted,
    matching a production backpressure path, and is zero in all tests).
    """
    if decomposition is None:
        decomposition = join_order(q, decompose(q))
    subs = [_compile_subquery(q, tc) for tc in decomposition]
    for s in subs:
        for lv in s.levels:
            lv.capacity = level_capacity
            lv.max_new = max_new

    l0_joins: list[JoinSpec] = []
    if len(subs) > 1:
        a_vl: tuple[int, ...] = subs[0].vertex_layout
        a_el: tuple[int, ...] = subs[0].edge_layout
        for i in range(1, len(subs)):
            js = _join_spec(q, a_vl, a_el, subs[i].vertex_layout, subs[i].edge_layout)
            js.capacity = l0_capacity
            js.max_new = max_new
            l0_joins.append(js)
            a_vl, a_el = js.vertex_layout, js.edge_layout

    edge_site: dict[int, tuple[int, int]] = {}
    for si, s in enumerate(subs):
        for li, lv in enumerate(s.levels):
            edge_site[lv.qedge] = (si, li)

    n_qe = q.n_edges
    esl = np.array([q.vertex_labels[q.edges[e][0]] for e in range(n_qe)], np.int32)
    edl = np.array([q.vertex_labels[q.edges[e][1]] for e in range(n_qe)], np.int32)
    eel = np.array(list(q.edge_labels), np.int32)

    return ExecutionPlan(
        query=q,
        window=window,
        subqueries=subs,
        l0_joins=l0_joins,
        edge_src_label=esl,
        edge_dst_label=edl,
        edge_edge_label=eel,
        decomposition_sizes=tuple(len(t) for t in decomposition),
        edge_site=edge_site,
    )
