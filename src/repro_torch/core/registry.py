"""Standing-query registry + structural plan signatures.

``QueryRegistry`` owns the lifecycle of registered continuous queries:
qid allocation, compilation (``compile_plan``) with uniform capacities,
and the *structural signature* used by the service layer to bucket
queries into padded slot groups (``repro_torch.core.multi.build_slot_tick``).

The signature captures everything ``build_tick_body`` closes over —
expansion-list level layouts, REL/TREL matrices, capacities, join specs
— and deliberately EXCLUDES the per-edge label arrays and the window
span, which are runtime slot data.  Two plans with equal signatures are
interchangeable under one compiled slot tick.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.decompose import TCSubquery
from repro_torch.core.plan import ExecutionPlan, compile_plan
from repro_torch.core.query import QueryGraph


def plan_decomposition(plan: ExecutionPlan) -> list[tuple[int, ...]]:
    """The plan's (ordered) TC-subquery timing sequences — enough to
    recompile the SAME plan, bypassing the decomposition heuristics
    (checkpoint manifests round-trip plans through this)."""
    return [tuple(s.timing_sequence) for s in plan.subqueries]


def plan_signature(plan: ExecutionPlan) -> tuple:
    """Hashable structural fingerprint of an ExecutionPlan.

    Includes: per-subquery timing sequences and level specs (matched
    query edge, slot wiring, layouts, capacities), and per-L0-join REL /
    TREL matrices, new-vertex slots, layouts, and capacities.  Excludes:
    vertex/edge *labels* and the window span (runtime slot parameters).
    """
    subs = tuple(
        (
            s.timing_sequence,
            tuple(
                (lv.qedge, lv.src_slot, lv.dst_slot, lv.new_vertices,
                 lv.vertex_layout, lv.capacity, lv.max_new)
                for lv in s.levels
            ),
        )
        for s in plan.subqueries
    )
    joins = tuple(
        (js.rel.shape, js.rel.tobytes(), js.trel.shape, js.trel.tobytes(),
         js.b_new_vertex_slots, js.vertex_layout, js.edge_layout,
         js.capacity, js.max_new)
        for js in plan.l0_joins
    )
    return (subs, joins)


@dataclass
class RegisteredQuery:
    """One standing query: its graph, window, compiled plan, signature."""

    qid: int
    query: QueryGraph
    window: int
    plan: ExecutionPlan
    signature: tuple = field(repr=False)


class QueryRegistry:
    """qid -> compiled standing query, with structural grouping info.

    Capacities are uniform across registered queries (they are part of
    the structural signature, so differing capacities would fragment the
    slot groups for no benefit at this layer).
    """

    def __init__(self, level_capacity: int = 4096, l0_capacity: int = 4096,
                 max_new: int = 1024):
        self.level_capacity = level_capacity
        self.l0_capacity = l0_capacity
        self.max_new = max_new
        self._queries: dict[int, RegisteredQuery] = {}
        self._next_qid = 0

    # ------------------------------------------------------------------ #
    def compile(self, query: QueryGraph, window: int,
                decomposition=None) -> ExecutionPlan:
        """Compile with this registry's uniform capacities (host-side).

        ``decomposition``: optional ordered timing sequences (the
        ``plan_decomposition`` form) to reproduce an exact plan instead
        of re-running the decomposition/join-order heuristics.
        """
        if decomposition is not None:
            decomposition = [
                TCSubquery(frozenset(seq), tuple(seq))
                for seq in decomposition
            ]
        return compile_plan(
            query, window,
            decomposition=decomposition,
            level_capacity=self.level_capacity,
            l0_capacity=self.l0_capacity,
            max_new=self.max_new,
        )

    def register(self, query: QueryGraph, window: int,
                 plan: ExecutionPlan | None = None) -> int:
        """Register a standing query; with ``plan`` given, serve that
        EXACT plan (custom decomposition / capacities) instead of
        compiling one.

        Every plan — compiled here or supplied — must satisfy the
        paper's decomposition invariants (edge-disjoint cover, valid
        timing sequences, prefix-connected join order, coherent
        REL/TREL and prefix-chain slices); a violating plan raises
        ``repro_torch.analysis.PlanInvariantError`` before any registry state
        is touched."""
        if plan is None:
            plan = self.compile(query, window)
        elif plan.query != query or plan.window != window:
            raise ValueError("plan does not match the given query/window")
        else:
            # capacities must be the registry's: checkpoint restore
            # recompiles from (query, window, decomposition) with the
            # registry's capacities, so divergent ones would not
            # round-trip (and would fragment slot groups for no benefit)
            level_caps = {(lv.capacity, lv.max_new)
                          for s in plan.subqueries for lv in s.levels}
            l0_caps = {(js.capacity, js.max_new) for js in plan.l0_joins}
            if level_caps != {(self.level_capacity, self.max_new)} or \
                    (l0_caps and
                     l0_caps != {(self.l0_capacity, self.max_new)}):
                raise ValueError(
                    "plan capacities differ from the registry's "
                    f"(level={self.level_capacity}, l0={self.l0_capacity}, "
                    f"max_new={self.max_new})")
        # fail-fast BEFORE qid allocation: a rejected plan must leave
        # the registry (and the service layers above it) untouched
        from repro_torch.analysis.plan_check import verify_plan
        verify_plan(plan, symbol=f"register(window={window})")
        qid = self._next_qid
        self._next_qid += 1
        self._queries[qid] = RegisteredQuery(
            qid=qid, query=query, window=window, plan=plan,
            signature=plan_signature(plan),
        )
        return qid

    def adopt(self, qid: int, query: QueryGraph, window: int,
              decomposition=None) -> RegisteredQuery:
        """Re-insert a query under a FIXED qid (checkpoint-restore path):
        the restored service must hand tenants back their original ids.
        Bumps the qid allocator past ``qid`` so later ``register`` calls
        stay collision-free."""
        if qid in self._queries:
            raise ValueError(f"qid {qid} already registered")
        plan = self.compile(query, window, decomposition=decomposition)
        # restore path: a manifest carrying a corrupted decomposition
        # must fail restore, not serve wrong-semantics matches
        from repro_torch.analysis.plan_check import verify_plan
        verify_plan(plan, symbol=f"adopt(qid={qid})")
        rq = RegisteredQuery(
            qid=qid, query=query, window=window, plan=plan,
            signature=plan_signature(plan),
        )
        self._queries[qid] = rq
        self._next_qid = max(self._next_qid, qid + 1)
        return rq

    def unregister(self, qid: int) -> RegisteredQuery:
        return self._queries.pop(qid)

    @property
    def next_qid(self) -> int:
        return self._next_qid

    # ------------------------------------------------------------------ #
    def get(self, qid: int) -> RegisteredQuery:
        return self._queries[qid]

    def qids(self) -> list[int]:
        return sorted(self._queries)

    def plans(self) -> list[ExecutionPlan]:
        """Active plans in qid order — the input to ``build_multi_tick``."""
        return [self._queries[q].plan for q in self.qids()]

    def __len__(self) -> int:
        return len(self._queries)

    def __contains__(self, qid: int) -> bool:
        return qid in self._queries
