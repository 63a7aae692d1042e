"""Plan invariant verifier: the paper's decomposition discipline, checked.

A copy of ``repro.analysis.plan_check`` over the port's own plan types
(``QueryRegistry.register``/``adopt`` call ``verify_plan``).

The correctness argument of Li et al. 2018 rests on structural
properties of the compiled plan — TC-subqueries that cover the query's
edges exactly once with timing-chained, prefix-connected sequences
(Algorithms 5–6, Definitions 9/10/14).  ``compile_plan`` produces such
plans for planner-chosen decompositions, but callers may also supply a
hand-built decomposition (``QueryRegistry.register(..., plan=...)``,
the sjtree ablations, restore paths) — and nothing verified them until
now.  ``verify_plan`` re-derives every invariant from the plan's own
``QueryGraph`` and fails fast with ``PlanInvariantError``; the CLI runs
whole-corpus sweeps over the planner's output.

Rules (all ERROR unless noted):

PC101  the decomposition is an edge-disjoint cover: the timing
       sequences partition {0..n_edges-1} with no overlap or repeat;
PC102  every timing sequence satisfies Definition 10: prefix-connected
       and consecutively ≺-chained (``QueryGraph.is_timing_sequence``);
PC103  the join order is prefix-connected (Definition 14): each
       subquery after the first shares a query vertex with the union of
       its predecessors, so every L0 join has at least one REL equality
       and never degenerates to a cross product;
PC104  level specs agree with a fresh ``_compile_subquery`` of the
       stored timing sequence (slot layouts cannot drift from the
       sequences they were compiled from);
PC105  every L0 ``JoinSpec``'s REL/TREL/layouts agree with a fresh
       ``_join_spec`` over the stored layouts;
PC106  ``edge_site`` is a consistent inverse of the level map and
       covers every query edge;
PC107  the per-edge label tables match the query's labels;
PC108  window and every capacity / max_new are positive;
PC109  each ``share.prefix_chain`` slice is itself a timing-chain
       prefix: per-depth queries are ≺-chains that extend one another
       edge-by-edge, and every signature carries the plan's window;
PC110  (info) the registered query is not ``canonical_form``'s fixed
       point — isomorphic authorings will not share a compiled tick
       until canonicalized (the api layer does this automatically).
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import ERROR, INFO, Finding

__all__ = ["PlanInvariantError", "check_plan", "verify_plan",
           "verify_corpus"]


class PlanInvariantError(ValueError):
    """A compiled plan violates the paper's decomposition invariants."""

    def __init__(self, findings):
        self.findings = list(findings)
        msgs = "; ".join(f"{f.rule}: {f.message}" for f in self.findings)
        super().__init__(f"plan invariant violation: {msgs}")


def _f(rule, severity, symbol, message):
    return Finding(pass_name="plan", rule=rule, severity=severity,
                   path="", line=0, symbol=symbol, message=message)


def check_plan(plan, symbol: str = "plan") -> list[Finding]:
    """All invariant findings for one ``ExecutionPlan`` (never raises)."""
    from repro_torch.core.canon import canonical_form
    from repro_torch.core.plan import _compile_subquery, _join_spec
    from repro_torch.core.decompose import TCSubquery
    from repro_torch.core.share import prefix_chain

    q = plan.query
    out: list[Finding] = []
    seqs = [tuple(s.timing_sequence) for s in plan.subqueries]

    # PC101: edge-disjoint cover
    flat = [e for s in seqs for e in s]
    if sorted(flat) != list(range(q.n_edges)):
        out.append(_f("PC101", ERROR, symbol,
                      f"timing sequences {seqs} are not an edge-disjoint "
                      f"cover of {{0..{q.n_edges - 1}}}"))

    # PC102: each sequence is a valid timing sequence (Def. 10)
    for si, seq in enumerate(seqs):
        if not seq:
            out.append(_f("PC102", ERROR, symbol,
                          f"subquery {si} has an empty timing sequence"))
            continue
        if not all(0 <= e < q.n_edges for e in seq):
            out.append(_f("PC102", ERROR, symbol,
                          f"subquery {si} references unknown edges {seq}"))
            continue
        if not q.is_timing_sequence(seq):
            out.append(_f("PC102", ERROR, symbol,
                          f"subquery {si} sequence {seq} is not prefix-"
                          f"connected + consecutively ≺-chained "
                          f"(Def. 10)"))

    # PC103: prefix-connected join order (Def. 14)
    if len(seqs) > 1 and all(
            s and all(0 <= e < q.n_edges for e in s) for s in seqs):
        bound = set(q.vertices_of(seqs[0]))
        for si in range(1, len(seqs)):
            verts = set(q.vertices_of(seqs[si]))
            if not bound & verts:
                out.append(_f(
                    "PC103", ERROR, symbol,
                    f"join order not prefix-connected at subquery {si}: "
                    f"{seqs[si]} shares no vertex with the joined prefix "
                    f"(the L0 join would be a cross product)"))
            bound |= verts

    # PC104: level specs match a fresh compile of the stored sequence
    for si, s in enumerate(plan.subqueries):
        if not s.timing_sequence or not all(
                0 <= e < q.n_edges for e in s.timing_sequence):
            continue
        fresh = _compile_subquery(q, TCSubquery(
            frozenset(s.timing_sequence), tuple(s.timing_sequence)))
        if len(fresh.levels) != len(s.levels):
            out.append(_f("PC104", ERROR, symbol,
                          f"subquery {si}: {len(s.levels)} levels stored, "
                          f"{len(fresh.levels)} recompiled"))
            continue
        for li, (lv, ref) in enumerate(zip(s.levels, fresh.levels)):
            stored = (lv.qedge, lv.src_v, lv.dst_v, lv.src_slot,
                      lv.dst_slot, tuple(lv.new_vertices),
                      tuple(lv.vertex_layout))
            want = (ref.qedge, ref.src_v, ref.dst_v, ref.src_slot,
                    ref.dst_slot, tuple(ref.new_vertices),
                    tuple(ref.vertex_layout))
            if stored != want:
                out.append(_f(
                    "PC104", ERROR, symbol,
                    f"subquery {si} level {li} drifted from its timing "
                    f"sequence: stored {stored} != recompiled {want}"))

    # PC105: L0 join specs match fresh _join_spec over stored layouts
    if plan.l0_joins and len(plan.subqueries) == len(plan.l0_joins) + 1:
        a_vl = plan.subqueries[0].vertex_layout
        a_el = plan.subqueries[0].edge_layout
        for ji, js in enumerate(plan.l0_joins):
            b = plan.subqueries[ji + 1]
            ref = _join_spec(q, a_vl, a_el, b.vertex_layout, b.edge_layout)
            if (not np.array_equal(js.rel, ref.rel)
                    or not np.array_equal(js.trel, ref.trel)
                    or tuple(js.b_new_vertex_slots)
                    != tuple(ref.b_new_vertex_slots)
                    or tuple(js.vertex_layout) != tuple(ref.vertex_layout)
                    or tuple(js.edge_layout) != tuple(ref.edge_layout)):
                out.append(_f(
                    "PC105", ERROR, symbol,
                    f"L0 join {ji} REL/TREL/layouts disagree with "
                    f"_join_spec over the stored layouts"))
            a_vl, a_el = js.vertex_layout, js.edge_layout
    elif len(plan.l0_joins) != max(0, len(plan.subqueries) - 1):
        out.append(_f("PC105", ERROR, symbol,
                      f"{len(plan.l0_joins)} L0 joins for "
                      f"{len(plan.subqueries)} subqueries"))

    # PC106: edge_site is a consistent inverse of the level map
    sites = dict(plan.edge_site)
    for si, s in enumerate(plan.subqueries):
        for li, lv in enumerate(s.levels):
            if sites.pop(lv.qedge, None) != (si, li):
                out.append(_f(
                    "PC106", ERROR, symbol,
                    f"edge_site[{lv.qedge}] != ({si}, {li})"))
    if sites:
        out.append(_f("PC106", ERROR, symbol,
                      f"edge_site has orphan entries {sites}"))

    # PC107: label tables match the query
    esl = [q.vertex_labels[q.edges[e][0]] for e in range(q.n_edges)]
    edl = [q.vertex_labels[q.edges[e][1]] for e in range(q.n_edges)]
    eel = list(q.edge_labels)
    if (list(plan.edge_src_label) != esl or list(plan.edge_dst_label) != edl
            or list(plan.edge_edge_label) != eel):
        out.append(_f("PC107", ERROR, symbol,
                      "edge label tables do not match the query's labels"))

    # PC108: positive window / capacities
    if int(plan.window) <= 0:
        out.append(_f("PC108", ERROR, symbol,
                      f"window {plan.window} is not positive"))
    for si, s in enumerate(plan.subqueries):
        for li, lv in enumerate(s.levels):
            if lv.capacity <= 0 or lv.max_new <= 0:
                out.append(_f("PC108", ERROR, symbol,
                              f"subquery {si} level {li} capacity/"
                              f"max_new not positive"))
    for ji, js in enumerate(plan.l0_joins):
        if js.capacity <= 0 or js.max_new <= 0:
            out.append(_f("PC108", ERROR, symbol,
                          f"L0 join {ji} capacity/max_new not positive"))

    # PC109: prefix_chain slices are timing-chain prefixes, same window
    if not any(f.rule in ("PC101", "PC102") for f in out):
        chain = prefix_chain(plan)
        if chain.depth != len(plan.subqueries[0].timing_sequence) \
                or len(chain.queries) != chain.depth:
            out.append(_f("PC109", ERROR, symbol,
                          "prefix_chain depth disagrees with subquery 0"))
        prev = None
        for d, (pq, sig) in enumerate(zip(chain.queries, chain.sigs)):
            if sig[1] != int(plan.window):
                out.append(_f("PC109", ERROR, symbol,
                              f"depth-{d + 1} signature window {sig[1]} "
                              f"!= plan window {plan.window}"))
            if not pq.is_timing_sequence(tuple(range(pq.n_edges))):
                out.append(_f("PC109", ERROR, symbol,
                              f"depth-{d + 1} prefix query is not a "
                              f"timing chain"))
            if prev is not None and (
                    pq.edges[:prev.n_edges] != prev.edges
                    or pq.edge_labels[:prev.n_edges] != prev.edge_labels
                    or pq.vertex_labels[:prev.n_vertices]
                    != prev.vertex_labels):
                out.append(_f("PC109", ERROR, symbol,
                              f"depth-{d + 1} prefix does not extend the "
                              f"depth-{d} prefix edge-by-edge"))
            prev = pq

    # PC110 (info): not a canonical_form fixed point
    if canonical_form(q).query != q:
        out.append(_f(
            "PC110", INFO, symbol,
            "query is not in canonical form; isomorphic authorings "
            "will not share a compiled tick (the repro.api planner "
            "canonicalizes automatically)"))
    return out


def verify_plan(plan, symbol: str = "plan",
                raise_on_error: bool = True) -> list[Finding]:
    """Check ``plan``; raise ``PlanInvariantError`` on any ERROR finding
    (info findings never raise)."""
    findings = check_plan(plan, symbol=symbol)
    errors = [f for f in findings if f.severity == ERROR]
    if errors and raise_on_error:
        raise PlanInvariantError(errors)
    return findings


# --------------------------------------------------------------------- #
# Corpus sweep (CLI): every planner-produced plan must verify clean.
# --------------------------------------------------------------------- #
def _corpus_queries():
    from repro_torch.core.query import QueryGraph, example_paper_query

    yield "paper_fig2", example_paper_query()
    # ≺-chain of growing length (the prefix-sharing workhorse)
    for n in (2, 3, 4):
        yield f"chain{n}", QueryGraph(
            n_vertices=n + 1,
            vertex_labels=tuple(range(n + 1)),
            edges=tuple((i, i + 1) for i in range(n)),
            edge_labels=(0,) * n,
            prec=frozenset((i, i + 1) for i in range(n - 1)),
        )
    # star: no precedence at all (all-singleton decomposition)
    yield "star4", QueryGraph(
        n_vertices=5, vertex_labels=(1, 0, 0, 0, 0),
        edges=((0, 1), (0, 2), (0, 3), (0, 4)),
        edge_labels=(-1,) * 4, prec=frozenset())
    # triangle with a full ≺-chain (single TC-subquery)
    yield "triangle_chain", QueryGraph(
        n_vertices=3, vertex_labels=(0, 0, 0),
        edges=((0, 1), (1, 2), (2, 0)), edge_labels=(0, 0, 0),
        prec=frozenset({(0, 1), (1, 2), (0, 2)}))
    # triangle, no precedence
    yield "triangle_free", QueryGraph(
        n_vertices=3, vertex_labels=(0, 1, 2),
        edges=((0, 1), (1, 2), (2, 0)), edge_labels=(0, 1, -1),
        prec=frozenset())


def verify_corpus() -> tuple[list[Finding], dict]:
    """Compile + verify the corpus; count plans checked."""
    from repro_torch.core.plan import compile_plan

    findings: list[Finding] = []
    n = 0
    for name, q in _corpus_queries():
        for window in (25, 1000):
            plan = compile_plan(q, window)
            findings += check_plan(plan, symbol=f"{name}@w{window}")
            n += 1
    return findings, {"n_plans_verified": n}
