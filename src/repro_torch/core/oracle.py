"""Exact pure-Python reference engine — the correctness oracle for tests.

Enumerates *all* timing-order-constrained subgraph matches (Definition 4)
of a query over the current window content by plain backtracking.  It is
exponential and only used on tiny inputs; the device engine's state must
equal its output after every tick (tests/test_engine_oracle.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.query import QueryGraph


@dataclass(frozen=True)
class DataEdge:
    src: int
    dst: int
    ts: int
    src_label: int
    dst_label: int
    edge_label: int = 0


def edge_matches(q: QueryGraph, eid: int, e: DataEdge) -> bool:
    u, v = q.edges[eid]
    if e.src == e.dst:
        return False  # query self-loops unsupported; injectivity forbids
    if q.vertex_labels[u] != e.src_label or q.vertex_labels[v] != e.dst_label:
        return False
    ql = q.edge_labels[eid]
    return ql == QueryGraph.WILDCARD or ql == e.edge_label


def enumerate_matches(q: QueryGraph, window: list[DataEdge]):
    """All matches of ``q`` over ``window``.

    Returns a set of frozensets of ``(query_edge_id, (src, dst, ts))`` —
    the same canonical form as ``engine.current_matches``.
    """
    m = q.n_edges
    results = set()
    binding: dict[int, int] = {}   # query vertex -> data vertex
    used_data_vertices: dict[int, int] = {}  # data vertex -> query vertex
    chosen: list[DataEdge | None] = [None] * m

    def ts_ok(eid: int, e: DataEdge) -> bool:
        for other in range(m):
            oe = chosen[other]
            if oe is None or other == eid:
                continue
            if q.precedes(other, eid) and not (oe.ts < e.ts):
                return False
            if q.precedes(eid, other) and not (e.ts < oe.ts):
                return False
        return True

    def bind_vertex(qv: int, dv: int) -> bool:
        if qv in binding:
            return binding[qv] == dv
        if dv in used_data_vertices:
            return False
        binding[qv] = dv
        used_data_vertices[dv] = qv
        return True

    def unbind(assigned: list[int]):
        for qv in assigned:
            dv = binding.pop(qv)
            used_data_vertices.pop(dv)

    def rec(eid: int):
        if eid == m:
            results.add(
                frozenset(
                    (k, (chosen[k].src, chosen[k].dst, chosen[k].ts))
                    for k in range(m)
                )
            )
            return
        u, v = q.edges[eid]
        for e in window:
            if not edge_matches(q, eid, e):
                continue
            if not ts_ok(eid, e):
                continue
            assigned: list[int] = []
            ok = True
            if u in binding:
                ok = binding[u] == e.src
            else:
                ok = bind_vertex(u, e.src)
                if ok:
                    assigned.append(u)
            if ok:
                if v in binding:
                    ok = binding[v] == e.dst
                else:
                    ok = bind_vertex(v, e.dst)
                    if ok:
                        assigned.append(v)
            if ok:
                chosen[eid] = e
                rec(eid + 1)
                chosen[eid] = None
            unbind(assigned)
        return

    rec(0)
    return results


class OracleEngine:
    """Sequential edge-at-a-time reference with a sliding window."""

    def __init__(self, q: QueryGraph, window: int):
        self.q = q
        self.window = window
        self.edges: list[DataEdge] = []
        self.t_now = 0
        self.n_rejected = 0

    def insert(self, e: DataEdge, watermark: int | None = None):
        """Insert one edge; slide the window.

        ``watermark=None`` is the processing-time clock (max ts seen).
        With a watermark (event-time replay, mirroring the engine's
        watermark mode): an edge at-or-below the already-released floor
        is rejected-and-counted before the clock moves, and the clock
        advances to ``min(watermark, e.ts)`` — bounded by the watermark
        so a force-evicted straggler cannot prematurely expire partials
        still inside ``allowed_lateness``.
        """
        if watermark is not None:
            if e.ts <= self.t_now - self.window:
                self.n_rejected += 1
                return
            self.t_now = max(self.t_now, min(watermark, e.ts))
        else:
            self.t_now = max(self.t_now, e.ts)
        lo = self.t_now - self.window
        self.edges = [x for x in self.edges if x.ts > lo]
        if e.ts > lo:
            self.edges.append(e)

    def matches(self):
        lo = self.t_now - self.window
        live = [x for x in self.edges if x.ts > lo]
        return enumerate_matches(self.q, live)
