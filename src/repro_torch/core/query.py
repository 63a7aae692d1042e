"""Query graph with timing-order constraints (paper Definitions 1-5).

A query is a directed, vertex-labelled (optionally edge-labelled) graph
plus a strict partial order ``prec`` over its edges: ``(i, j) in prec``
means a data edge matching query edge ``i`` must carry a strictly smaller
timestamp than the data edge matching query edge ``j`` (Definition 3/4).

Everything in this module is host-side query *compilation* state: plain
Python / numpy, hashable, and cheap.  The device engine never sees these
objects — it sees the numeric ``ExecutionPlan`` compiled from them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field


def _transitive_closure(n_edges: int, prec: frozenset[tuple[int, int]]) -> frozenset[tuple[int, int]]:
    """Floyd-Warshall style closure of the strict order over edge ids."""
    reach = [[False] * n_edges for _ in range(n_edges)]
    for i, j in prec:
        reach[i][j] = True
    for k in range(n_edges):
        rk = reach[k]
        for i in range(n_edges):
            if reach[i][k]:
                ri = reach[i]
                for j in range(n_edges):
                    if rk[j]:
                        ri[j] = True
    return frozenset(
        (i, j) for i in range(n_edges) for j in range(n_edges) if reach[i][j]
    )


@dataclass(frozen=True)
class QueryGraph:
    """Immutable query graph (Definition 3).

    Attributes
    ----------
    n_vertices:     number of query vertices (ids ``0..n_vertices-1``).
    vertex_labels:  label id per vertex.
    edges:          ``(src_vertex, dst_vertex)`` per query edge.
    edge_labels:    label id per query edge; ``WILDCARD`` matches any.
    prec:           strict partial order over edge ids, stored transitively
                    closed.  ``(i, j)``: edge i must precede edge j.
    """

    WILDCARD = -1

    n_vertices: int
    vertex_labels: tuple[int, ...]
    edges: tuple[tuple[int, int], ...]
    edge_labels: tuple[int, ...] = ()
    prec: frozenset[tuple[int, int]] = field(default_factory=frozenset)

    def __post_init__(self):
        if len(self.vertex_labels) != self.n_vertices:
            raise ValueError("vertex_labels length mismatch")
        if not self.edge_labels:
            object.__setattr__(
                self, "edge_labels", tuple(self.WILDCARD for _ in self.edges)
            )
        if len(self.edge_labels) != len(self.edges):
            raise ValueError("edge_labels length mismatch")
        for (u, v) in self.edges:
            if not (0 <= u < self.n_vertices and 0 <= v < self.n_vertices):
                raise ValueError(f"edge endpoint out of range: {(u, v)}")
            if u == v:
                raise ValueError("self-loops in query graphs are not supported")
        if len(set(self.edges)) != len(self.edges):
            raise ValueError("parallel duplicate query edges are not supported")
        closed = _transitive_closure(self.n_edges, frozenset(self.prec))
        for i, j in closed:
            if (j, i) in closed or i == j:
                raise ValueError("timing order is not a strict partial order")
        object.__setattr__(self, "prec", closed)

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def precedes(self, i: int, j: int) -> bool:
        """True iff edge i must come strictly before edge j."""
        return (i, j) in self.prec

    def preq(self, eid: int) -> frozenset[int]:
        """Prerequisite edge set of ``eid`` (Definition 6): {e' ≺ e} ∪ {e}."""
        return frozenset(
            i for i in range(self.n_edges) if self.precedes(i, eid)
        ) | {eid}

    # ------------------------------------------------------------------ #
    def edges_adjacent(self, i: int, j: int) -> bool:
        """Two query edges are connected iff they share an endpoint (Def. 1)."""
        a, b = self.edges[i], self.edges[j]
        return bool(set(a) & set(b))

    def subquery_connected(self, edge_ids: tuple[int, ...]) -> bool:
        """Connectivity of the subquery induced by ``edge_ids``."""
        if not edge_ids:
            return False
        remaining = set(edge_ids)
        frontier = {edge_ids[0]}
        remaining.discard(edge_ids[0])
        while frontier:
            nxt = {
                e for e in remaining
                if any(self.edges_adjacent(e, f) for f in frontier)
            }
            remaining -= nxt
            frontier = nxt
        return not remaining

    def is_connected(self) -> bool:
        return self.subquery_connected(tuple(range(self.n_edges)))

    # ------------------------------------------------------------------ #
    def is_prefix_connected(self, seq: tuple[int, ...]) -> bool:
        """Definition 9: every prefix of ``seq`` induces a connected subquery."""
        bound: set[int] = set()
        for k, e in enumerate(seq):
            u, v = self.edges[e]
            if k > 0 and not ({u, v} & bound):
                return False
            bound.update((u, v))
        return True

    def is_timing_sequence(self, seq: tuple[int, ...]) -> bool:
        """Definition 10: prefix-connected AND consecutive edges chained by ≺."""
        if not self.is_prefix_connected(seq):
            return False
        return all(self.precedes(seq[k], seq[k + 1]) for k in range(len(seq) - 1))

    def is_tc_query(self) -> bool:
        """Exhaustive check (exponential; for tests / tiny queries only)."""
        return any(
            self.is_timing_sequence(perm)
            for perm in itertools.permutations(range(self.n_edges))
        )

    # ------------------------------------------------------------------ #
    def to_spec(self) -> dict:
        """JSON-serializable description (checkpoint manifests round-trip
        registered queries through this)."""
        return {
            "n_vertices": self.n_vertices,
            "vertex_labels": list(self.vertex_labels),
            "edges": [list(e) for e in self.edges],
            "edge_labels": list(self.edge_labels),
            "prec": sorted(list(p) for p in self.prec),
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "QueryGraph":
        """Inverse of ``to_spec`` (prec re-closes transitively, a no-op
        for specs produced by ``to_spec``)."""
        return cls(
            n_vertices=int(spec["n_vertices"]),
            vertex_labels=tuple(int(v) for v in spec["vertex_labels"]),
            edges=tuple((int(u), int(v)) for u, v in spec["edges"]),
            edge_labels=tuple(int(l) for l in spec["edge_labels"]),
            prec=frozenset((int(i), int(j)) for i, j in spec["prec"]),
        )

    # ------------------------------------------------------------------ #
    def vertices_of(self, edge_ids) -> tuple[int, ...]:
        """Sorted vertex ids touched by ``edge_ids``."""
        vs: set[int] = set()
        for e in edge_ids:
            vs.update(self.edges[e])
        return tuple(sorted(vs))

    def n_distinct_edge_labels(self) -> int:
        return len(set(self.edge_labels))


# ---------------------------------------------------------------------- #
def example_paper_query() -> QueryGraph:
    """The running example of the paper (Figure 4), reconstructed from the
    §5.5 TCsub listing.

    Timing order (paper's 1-based ids): ε3 ≺ ε1 ≺ ε2 and ε6 ≺ ε5 ≺ ε4.
    Structure chosen so that TCsub(Q) is exactly the paper's ten entries
    — {ε6,ε5,ε4}, {ε3,ε1}, {ε5,ε4}, {ε6,ε5} and the six singletons —
    which requires ε3/ε1 adjacent but ε1/ε2 NOT adjacent.  The resulting
    decomposition is the paper's {{ε6,ε5,ε4}, {ε3,ε1}, {ε2}} (Figure 7).
    """
    #       v0 v1 v2 v3 v4
    labels = (0, 1, 2, 3, 4)
    edges = (
        (0, 1),  # ε1
        (2, 3),  # ε2 (not adjacent to ε1)
        (4, 0),  # ε3 (shares v0 with ε1)
        (1, 2),  # ε4
        (3, 1),  # ε5 (shares v1 with ε4, v3 with ε6)
        (4, 3),  # ε6
    )
    prec = frozenset({(2, 0), (0, 1), (5, 4), (4, 3)})
    return QueryGraph(5, labels, edges, prec=prec)
