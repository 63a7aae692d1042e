"""Pattern planner: lower + canonicalize a ``Pattern`` for serving.

The planner is the layer where cross-tenant sharing is decided: it
lowers a ``Pattern`` to its authored ``QueryGraph``, then rewrites it
into canonical form (``repro_torch.core.canon``) so that *every* authoring of
the same structure — permuted vertex ids, reordered edges, renamed
vertices — compiles to the identical ``QueryGraph`` and therefore the
identical ``plan_signature``.  The service then packs such tenants into
one padded slot group under ONE compiled slot tick: registration of a
differently-authored isomorphic pattern is a pure device-data write.

``PatternPlan`` keeps the authored names alongside the canonical query,
so matches translate back into the tenant's vocabulary (vertex/edge
names), and round-trips through JSON for checkpoint manifests.

The port of ``repro.api.planner``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.api.events import LabelVocab
from repro_torch.api.pattern import Pattern
from repro_torch.core.canon import canonical_form
from repro_torch.core.query import QueryGraph


@dataclass(frozen=True)
class PatternPlan:
    """One pattern, planned: canonical query + name translation tables.

    ``vertex_map[i]`` / ``edge_map[j]`` give the canonical vertex/edge id
    of the pattern's i-th vertex / j-th edge (authoring order);
    ``vertex_names`` / ``edge_names`` are the authored names in the same
    order.  ``query`` is canonical — feed it to the service, never the
    authored graph, or isomorphic tenants stop sharing compiled ticks.
    """

    name: str | None
    query: QueryGraph
    window: int
    vertex_names: tuple[str, ...]
    edge_names: tuple[str, ...]
    vertex_map: tuple[int, ...]
    edge_map: tuple[int, ...]

    # ------------------------------------------------------------------ #
    @classmethod
    def identity(cls, query: QueryGraph, window: int,
                 name: str | None = None) -> "PatternPlan":
        """Plan for a query registered BELOW the DSL (raw QueryGraph or
        exact ExecutionPlan): synthesized ``v0..``/``e0..`` names,
        identity maps, no canonical rewrite."""
        return cls(
            name=name, query=query, window=window,
            vertex_names=tuple(f"v{i}" for i in range(query.n_vertices)),
            edge_names=tuple(f"e{j}" for j in range(query.n_edges)),
            vertex_map=tuple(range(query.n_vertices)),
            edge_map=tuple(range(query.n_edges)),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "query": self.query.to_spec(),
            "window": int(self.window),
            "vertex_names": list(self.vertex_names),
            "edge_names": list(self.edge_names),
            "vertex_map": list(self.vertex_map),
            "edge_map": list(self.edge_map),
        }

    @classmethod
    def from_json(cls, spec: dict) -> "PatternPlan":
        return cls(
            name=spec.get("name"),
            query=QueryGraph.from_spec(spec["query"]),
            window=int(spec["window"]),
            vertex_names=tuple(spec["vertex_names"]),
            edge_names=tuple(spec["edge_names"]),
            vertex_map=tuple(int(v) for v in spec["vertex_map"]),
            edge_map=tuple(int(e) for e in spec["edge_map"]),
        )


def compile_pattern(pattern: Pattern, vocab: LabelVocab | None = None) -> PatternPlan:
    """Lower ``pattern`` through ``vocab`` and canonicalize it."""
    authored, window = pattern.build(vocab)
    canon = canonical_form(authored)
    return PatternPlan(
        name=pattern.name,
        query=canon.query,
        window=window,
        vertex_names=pattern.vertex_names,
        edge_names=pattern.edge_names,
        vertex_map=canon.vertex_map,
        edge_map=canon.edge_map,
    )
