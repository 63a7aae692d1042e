"""Host-side prefix slicing for cross-tenant prefix sharing.

Only ``prefix_chain`` is ported so far: the plan verifier's PC109 rule
reads it.  The shared-prefix forest itself (``SharedPrefixForest``,
``build_node_tick``, ``NodeView``) is a later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.canon import canonical_key
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.query import QueryGraph


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
