"""SJ-tree baseline (Choudhury et al., EDBT 2015) with timing post-filter:
the port of ``repro.core.sjtree``.

The paper's main competitor: a left-deep subgraph-join tree that
maintains partial matches per node but (a) ignores timing constraints
during maintenance (post-processing filter only, as §6.3 describes) and
therefore (b) cannot prune discardable partial matches.

It runs on the same engine: the plan is compiled against a
*prec-stripped* copy of the query, every edge its own singleton
"TC-subquery", so each leaf stores all label-matching edges and the
left-deep internal nodes are exactly the L0 join chain; the emitted
matches are then filtered by the original timing order on the host.
The space blow-up relative to the timing-aware engine is the paper's
headline comparison (Figures 14-17).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.decompose import TCSubquery
from repro_torch.core.plan import ExecutionPlan, compile_plan
from repro_torch.core.query import QueryGraph


def strip_timing(q: QueryGraph) -> QueryGraph:
    return QueryGraph(
        n_vertices=q.n_vertices,
        vertex_labels=q.vertex_labels,
        edges=q.edges,
        edge_labels=q.edge_labels,
        prec=frozenset(),
    )


def _prefix_connected_singleton_order(q: QueryGraph) -> list[TCSubquery]:
    """Left-deep leaf order: any prefix-connected permutation of edges."""
    order: list[int] = [0]
    bound = set(q.edges[0])
    remaining = set(range(1, q.n_edges))
    while remaining:
        nxt = next(
            e for e in sorted(remaining) if set(q.edges[e]) & bound
        )
        order.append(nxt)
        bound |= set(q.edges[nxt])
        remaining.discard(nxt)
    return [TCSubquery(frozenset({e}), (e,)) for e in order]


def compile_sjtree_plan(
    q: QueryGraph,
    window: int,
    level_capacity: int = 4096,
    l0_capacity: int = 4096,
    max_new: int = 1024,
) -> tuple[ExecutionPlan, np.ndarray]:
    """Returns (plan over prec-stripped query, postfilter TREL).

    The postfilter TREL is an int8 [ne, ne] matrix over the plan's final
    edge layout: entry (i, j) == -1 requires ts_i < ts_j (the ORIGINAL
    query's timing order).  Apply with ``timing_postfilter``.
    """
    qs = strip_timing(q)
    decomp = _prefix_connected_singleton_order(qs)
    plan = compile_plan(
        qs, window, decomposition=decomp,
        level_capacity=level_capacity, l0_capacity=l0_capacity,
        max_new=max_new)
    layout = plan.final_edge_layout
    ne = len(layout)
    trel = np.zeros((ne, ne), np.int8)
    for i, ei in enumerate(layout):
        for j, ej in enumerate(layout):
            if q.precedes(ei, ej):
                trel[i, j] = -1
    return plan, trel


def timing_postfilter(ets: np.ndarray, valid: np.ndarray, trel: np.ndarray):
    """Filter emitted matches by the original timing order (host-side):
    ``ets`` [rows, ne] and ``valid`` [rows] are host numpy arrays (a
    table's ``.cpu().numpy()``)."""
    ok = valid.copy()
    ne = trel.shape[0]
    for i in range(ne):
        for j in range(ne):
            if trel[i, j] == -1:
                ok &= ets[:, i] < ets[:, j]
    return ok
