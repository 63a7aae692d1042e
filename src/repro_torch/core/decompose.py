"""TC-subquery enumeration, decomposition and join-order selection.

Implements the paper's query-compilation pipeline:

* ``tc_subqueries``  — Algorithm 5: enumerate all TC-subqueries of Q by
  dynamic programming over timing-chained, prefix-connected sequences.
* ``decompose``      — Algorithm 6: greedy minimum-cardinality cover of Q
  by edge-disjoint TC-subqueries (cost model of Theorem 5: the expected
  number of join operations per incoming edge grows with |D|, so |D| is
  minimized).
* ``join_order``     — Section 5.6: prefix-connected permutation of the
  decomposition maximizing the joint number (Definition 14) at each step.

All of this is host-side and runs once per continuous query registration.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.query import QueryGraph


@dataclass(frozen=True)
class TCSubquery:
    """A TC-subquery: an edge set plus one witness timing sequence."""

    edge_ids: frozenset[int]
    timing_sequence: tuple[int, ...]

    def __len__(self) -> int:
        return len(self.edge_ids)


def tc_subqueries(q: QueryGraph, max_enum: int = 200_000) -> list[TCSubquery]:
    """Algorithm 5: all TC-subqueries of ``q``.

    Iterative DFS (an explicit LIFO stack — ``queue.pop()`` takes the
    most recently pushed sequence) over timing sequences: a sequence
    ``(e_1..e_j)`` extends to ``(e_1..e_j, e_x)`` iff ``e_j ≺ e_x`` and
    ``e_x`` is adjacent to some edge already in the sequence
    (prefix-connectivity).  Dedups by edge *set*, keeping the first
    witness sequence found.

    The traversal order is deterministic and LOAD-BEARING: the
    first-witness sequence chosen for each edge set flows into
    ``plan_signature`` (slot-group sharing) and into checkpoint
    manifests (``plan_decomposition``), so changing the order — e.g.
    switching to the BFS the paper's prose suggests — would silently
    invalidate cross-process sharing and restored checkpoints.
    ``tests/test_query.py::test_tc_subquery_enumeration_deterministic``
    pins the exact enumeration for the paper's Figure-2 query.
    """
    seen_sets: dict[frozenset[int], tuple[int, ...]] = {}
    queue: list[tuple[int, ...]] = [(e,) for e in range(q.n_edges)]
    n_enum = 0
    while queue:
        seq = queue.pop()
        n_enum += 1
        if n_enum > max_enum:
            raise RuntimeError(
                f"TC-subquery enumeration exceeded {max_enum} sequences; "
                "query precedence structure too dense — supply a manual "
                "decomposition via plan.compile_plan(decomposition=...)"
            )
        eset = frozenset(seq)
        if eset not in seen_sets:
            seen_sets[eset] = seq
        last = seq[-1]
        for ex in range(q.n_edges):
            if ex in eset:
                continue
            if not q.precedes(last, ex):
                continue
            if not any(q.edges_adjacent(ex, e) for e in seq):
                continue
            new_set = eset | {ex}
            if new_set in seen_sets:
                continue
            queue.append(seq + (ex,))
    return [TCSubquery(s, wit) for s, wit in seen_sets.items()]


def decompose(q: QueryGraph) -> list[TCSubquery]:
    """Algorithm 6: greedy edge-disjoint cover of Q by TC-subqueries.

    Repeatedly picks the largest remaining TC-subquery that is edge-
    disjoint from everything already chosen.  Single edges are always
    TC-subqueries, so a cover always exists.
    """
    if not q.is_connected():
        raise ValueError("query graph must be connected")
    pool = sorted(
        tc_subqueries(q),
        key=lambda t: (-len(t), t.timing_sequence),
    )
    chosen: list[TCSubquery] = []
    covered: set[int] = set()
    for cand in pool:
        if covered >= set(range(q.n_edges)):
            break
        if cand.edge_ids & covered:
            continue
        chosen.append(cand)
        covered |= cand.edge_ids
    assert covered == set(range(q.n_edges)), "greedy cover failed to cover Q"
    return chosen


# ---------------------------------------------------------------------- #
def joint_number(q: QueryGraph, a_edges: frozenset[int], b_edges: frozenset[int]) -> int:
    """Definition 14: |common vertices| + |timing-related edge pairs|."""
    va = set(q.vertices_of(a_edges))
    vb = set(q.vertices_of(b_edges))
    n_v = len(va & vb)
    n_t = sum(
        1
        for ea in a_edges
        for eb in b_edges
        if q.precedes(ea, eb) or q.precedes(eb, ea)
    )
    return n_v + n_t


def _connected_to(q: QueryGraph, union_vs: set[int], cand: TCSubquery) -> bool:
    return bool(union_vs & set(q.vertices_of(cand.edge_ids)))


def join_order(q: QueryGraph, decomposition: list[TCSubquery]) -> list[TCSubquery]:
    """Section 5.6: prefix-connected order over D maximizing joint number.

    Greedy: the first two TC-subqueries are the connected pair with the
    largest joint number; each next pick is the TC-subquery connected to
    the union with the largest joint number against the union.
    """
    d = list(decomposition)
    if len(d) == 1:
        return d
    best_pair = None
    best_jn = -1
    for i in range(len(d)):
        for j in range(i + 1, len(d)):
            vi = set(q.vertices_of(d[i].edge_ids))
            vj = set(q.vertices_of(d[j].edge_ids))
            if not (vi & vj):
                continue
            jn = joint_number(q, d[i].edge_ids, d[j].edge_ids)
            if jn > best_jn:
                best_jn, best_pair = jn, (i, j)
    if best_pair is None:
        raise ValueError("decomposition is not connectable — query disconnected?")
    i, j = best_pair
    ordered = [d[i], d[j]]
    remaining = [t for k, t in enumerate(d) if k not in (i, j)]
    union_edges = set(d[i].edge_ids | d[j].edge_ids)
    while remaining:
        union_vs = set(q.vertices_of(union_edges))
        best_k, best_jn = None, -1
        for k, cand in enumerate(remaining):
            if not _connected_to(q, union_vs, cand):
                continue
            jn = joint_number(q, frozenset(union_edges), cand.edge_ids)
            if jn > best_jn:
                best_jn, best_k = jn, k
        if best_k is None:
            raise ValueError("no prefix-connected extension found")
        ordered.append(remaining.pop(best_k))
        union_edges |= ordered[-1].edge_ids
    return ordered


def expected_join_ops(q: QueryGraph, k: int) -> float:
    """Theorem 5 cost model: N = (|E(Q)| - 1 + k(k-1)/2) / d."""
    d = max(1, q.n_distinct_edge_labels())
    return (q.n_edges - 1 + k * (k - 1) / 2) / d
