"""Canonical forms for timing-constrained query graphs.

Two tenants rarely author the "same" pattern the same way: vertex ids
are arbitrary, edges are listed in whatever order the author thought of
them, and the timing order is stated over those arbitrary edge ids.  The
engine, however, buckets standing queries into padded slot groups by
*structural* plan signature (``repro_torch.core.registry.plan_signature``), and
the decomposition / join-order heuristics consume edge ids directly — so
two isomorphic-modulo-relabeling queries can compile to differently-
ordered plans, land in different slot groups, and pay a needless
tick build each.

``canonical_form`` fixes the representation: it deterministically
relabels vertices and edges so that every member of an isomorphism class
maps to ONE canonical ``QueryGraph``.  The total order used to pick the
canonical representative compares *structure first, labels last*:

    (edges, closed precedence pairs, vertex labels, edge labels)

so the canonical EDGE ORDERING of two same-structure queries differs at
most by a structural automorphism — under which the unlabeled structure,
and therefore the compiled plan signature, is identical.  That is what
lets ``repro.api``'s planner map relabeled-isomorphic tenant patterns
onto one compiled slot tick.

The search enumerates vertex bijections restricted to Weisfeiler-Leman
style structural color classes (orbits refine fast on the paper's small,
timing-ordered queries); queries here are tiny (≤ ~10 edges), so the
residual within-class factorials are negligible.  A hard cap bounds the
worst case: pathologically symmetric queries beyond ``_MAX_PERMS``
candidate orderings fall back to a deterministic (but not relabeling-
invariant) refinement — still a valid relabeling, just without the
cross-authoring dedup guarantee.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

from repro_torch.core.query import QueryGraph


class CanonicalForm(NamedTuple):
    """A canonical relabeling of a query graph.

    ``vertex_map[v]`` / ``edge_map[e]`` give the canonical id of original
    vertex ``v`` / original edge ``e``; ``query`` is the relabeled graph.
    """

    query: QueryGraph
    vertex_map: tuple[int, ...]
    edge_map: tuple[int, ...]


_MAX_PERMS = 40320          # 8! — cap on candidate vertex orderings
_WL_ROUNDS = 3


def _vertex_colors(q: QueryGraph) -> list:
    """Structure-only vertex invariants (labels deliberately excluded:
    they are runtime slot data and must not steer the canonical edge
    ordering, or same-structure / different-label queries would stop
    sharing compiled ticks)."""
    # edge invariant: position of the edge inside the timing order
    einv = [
        (sum(1 for i in range(q.n_edges) if q.precedes(i, e)),
         sum(1 for j in range(q.n_edges) if q.precedes(e, j)))
        for e in range(q.n_edges)
    ]
    color = [
        (tuple(sorted(einv[e] for e in range(q.n_edges) if q.edges[e][0] == v)),
         tuple(sorted(einv[e] for e in range(q.n_edges) if q.edges[e][1] == v)))
        for v in range(q.n_vertices)
    ]
    for _ in range(_WL_ROUNDS):
        nxt = []
        for v in range(q.n_vertices):
            outs = tuple(sorted(
                (einv[e], color[q.edges[e][1]])
                for e in range(q.n_edges) if q.edges[e][0] == v))
            ins = tuple(sorted(
                (einv[e], color[q.edges[e][0]])
                for e in range(q.n_edges) if q.edges[e][1] == v))
            nxt.append((color[v], outs, ins))
        if len(set(map(repr, nxt))) == len(set(map(repr, color))):
            break
        color = nxt
    return color


def _candidate_orders(q: QueryGraph):
    """Vertex orderings consistent with the color classes (classes in
    deterministic color order, all permutations within each class)."""
    colors = _vertex_colors(q)
    classes: dict[str, list[int]] = {}
    for v in range(q.n_vertices):
        classes.setdefault(repr(colors[v]), []).append(v)
    groups = [classes[c] for c in sorted(classes)]
    n_perms = 1
    for g in groups:
        for k in range(2, len(g) + 1):
            n_perms *= k
    if n_perms > _MAX_PERMS:
        # degenerate symmetry: refine deterministically by (label, id).
        # Not relabeling-invariant, but still a valid canonical-ish
        # relabeling — and unreachable for the paper's query sizes.
        order = [v for g in groups
                 for v in sorted(g, key=lambda v: (q.vertex_labels[v], v))]
        yield order
        return
    for combo in itertools.product(*(itertools.permutations(g) for g in groups)):
        yield [v for g in combo for v in g]


def _encode(q: QueryGraph, order: list[int]):
    """Relabel by ``order`` and encode as a comparable key.

    ``order[k]`` is the original vertex given canonical id ``k``.
    """
    perm = [0] * q.n_vertices            # original vid -> canonical vid
    for new, old in enumerate(order):
        perm[old] = new
    by_endpoint = sorted(
        range(q.n_edges),
        key=lambda e: (perm[q.edges[e][0]], perm[q.edges[e][1]]))
    emap = [0] * q.n_edges               # original eid -> canonical eid
    for new, old in enumerate(by_endpoint):
        emap[old] = new
    edges = tuple((perm[q.edges[e][0]], perm[q.edges[e][1]])
                  for e in by_endpoint)
    prec = tuple(sorted((emap[i], emap[j]) for i, j in q.prec))
    vlabels = tuple(q.vertex_labels[old] for old in order)
    elabels = tuple(q.edge_labels[e] for e in by_endpoint)
    key = (edges, prec, vlabels, elabels)
    return key, tuple(perm), tuple(emap)


@functools.lru_cache(maxsize=4096)
def canonical_form(q: QueryGraph) -> CanonicalForm:
    """Deterministic canonical relabeling of ``q``.

    Properties (property-tested in tests/test_api_props.py):

    * invariance — any vertex renumbering / edge reordering of ``q``
      yields the same canonical ``query``;
    * idempotence — ``canonical_form(canonical_form(q).query)`` is the
      identity relabeling;
    * structure-first — two queries differing only in labels get
      canonical edge orderings related by a structural automorphism, so
      their compiled plans share one ``plan_signature``.
    """
    best = None
    for order in _candidate_orders(q):
        enc = _encode(q, order)
        if best is None or enc[0] < best[0]:
            best = enc
    key, perm, emap = best
    edges, prec, vlabels, elabels = key
    canon = QueryGraph(
        n_vertices=q.n_vertices,
        vertex_labels=vlabels,
        edges=edges,
        edge_labels=elabels,
        prec=frozenset(prec),
    )
    return CanonicalForm(query=canon, vertex_map=perm, edge_map=emap)


def canonical_key(q: QueryGraph) -> tuple:
    """Hashable identity of ``q``'s isomorphism class (labels included)."""
    c = canonical_form(q).query
    return (c.edges, tuple(sorted(c.prec)), c.vertex_labels, c.edge_labels)
