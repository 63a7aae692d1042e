"""Fluent, declarative timing-constrained pattern DSL.

The paper's interface is declarative: state a timing-constrained query
pattern, continuously receive matches.  ``Pattern`` is that statement —
named vertices, labelled edges, ``before`` timing constraints, one
sliding window::

    p = (Pattern("lateral-movement")
         .edge("a", "b", label="login")
         .edge("b", "c", label="xfer")
         .before(0, 1)          # login strictly precedes xfer
         .window(300))

Edges are referred to by authoring index (0, 1, ...) or by an explicit
``name=``; vertices are named strings and may carry labels (declared
inline at first mention via ``.vertex`` or left unlabeled).  ``build``
lowers the pattern into the internal ``QueryGraph`` *as authored* —
canonicalization (so differently-authored isomorphic patterns share one
compiled slot tick) is the planner's job (``repro_torch.api.planner``).

The port of ``repro.api.pattern``.
"""

from __future__ import annotations

from repro_torch.api.events import UNLABELED, LabelVocab
from repro_torch.core.query import QueryGraph


class PatternError(ValueError):
    """A malformed pattern (caught at authoring/build time, not serving)."""


class Pattern:
    """Fluent DSL for one timing-constrained continuous query."""

    def __init__(self, name: str | None = None):
        self.name = name
        self._vertices: list[str] = []          # first-mention order
        self._vertex_labels: dict[str, object] = {}
        self._edges: list[tuple[str, str, object]] = []   # (src, dst, label)
        self._edge_names: list[str] = []
        self._before: set[tuple[int, int]] = set()
        self._window: int | None = None

    # ------------------------------------------------------------------ #
    def vertex(self, name: str, label=None) -> "Pattern":
        """Declare a vertex, optionally labelled.  Re-declaring with a
        different label is an error (labels are identity, not hints)."""
        self._touch_vertex(name)
        if label is not None:
            prev = self._vertex_labels.get(name)
            if prev is not None and prev != label:
                raise PatternError(
                    f"vertex {name!r} relabelled: {prev!r} -> {label!r}")
            self._vertex_labels[name] = label
        return self

    def edge(self, src: str, dst: str, label=None, name: str | None = None,
             src_label=None, dst_label=None) -> "Pattern":
        """Add a directed pattern edge ``src -> dst``.

        ``label=None`` is a wildcard (matches any event label);
        ``src_label``/``dst_label`` are shorthand for ``.vertex`` calls.
        """
        if src == dst:
            raise PatternError(f"self-loop {src!r} -> {dst!r} not supported")
        if (src, dst) in {(s, d) for s, d, _ in self._edges}:
            raise PatternError(f"duplicate parallel edge {src!r} -> {dst!r}")
        self.vertex(src, src_label)
        self.vertex(dst, dst_label)
        ename = name if name is not None else f"e{len(self._edges)}"
        if ename in self._edge_names:
            raise PatternError(f"duplicate edge name {ename!r}")
        self._edges.append((src, dst, label))
        self._edge_names.append(ename)
        return self

    def before(self, first, second) -> "Pattern":
        """Timing constraint: edge ``first`` strictly precedes ``second``
        (by authoring index or ``name=``).  Transitive closure and
        strictness are validated at build."""
        self._before.add((self._edge_id(first), self._edge_id(second)))
        return self

    def window(self, span: int) -> "Pattern":
        """Sliding-window span in timestamp units."""
        if span <= 0:
            raise PatternError(f"window span must be positive, got {span}")
        self._window = int(span)
        return self

    # ------------------------------------------------------------------ #
    def _touch_vertex(self, name: str):
        if not isinstance(name, str) or not name:
            raise PatternError(f"vertex names must be non-empty str: {name!r}")
        if name not in self._vertices:
            self._vertices.append(name)

    def _edge_id(self, ref) -> int:
        if isinstance(ref, str):
            try:
                return self._edge_names.index(ref)
            except ValueError:
                raise PatternError(f"unknown edge name {ref!r} "
                                   f"(have {self._edge_names})") from None
        eid = int(ref)
        if not 0 <= eid < len(self._edges):
            raise PatternError(
                f"edge index {eid} out of range (have {len(self._edges)})")
        return eid

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return len(self._edges)

    @property
    def vertex_names(self) -> tuple[str, ...]:
        """Vertex names in authoring (first-mention) order."""
        return tuple(self._vertices)

    @property
    def edge_names(self) -> tuple[str, ...]:
        return tuple(self._edge_names)

    @property
    def window_span(self) -> int | None:
        return self._window

    # ------------------------------------------------------------------ #
    def build(self, vocab: LabelVocab | None = None) -> tuple[QueryGraph, int]:
        """Lower to ``(QueryGraph, window)`` in authoring order.

        Label tokens intern through ``vocab`` (a fresh one if omitted —
        sessions always pass their own so patterns and events agree).
        ``QueryGraph`` validation applies: the ``before`` constraints
        must close into a strict partial order.
        """
        if not self._edges:
            raise PatternError("pattern has no edges")
        if self._window is None:
            raise PatternError(
                "pattern has no window — call .window(span); a continuous "
                "query without a window would never expire state")
        vocab = LabelVocab() if vocab is None else vocab
        vid = {name: i for i, name in enumerate(self._vertices)}
        vlabels = tuple(
            vocab.intern(self._vertex_labels.get(name, UNLABELED))
            for name in self._vertices)
        elabels = tuple(
            QueryGraph.WILDCARD if lbl is None else vocab.intern(lbl)
            for _, _, lbl in self._edges)
        try:
            q = QueryGraph(
                n_vertices=len(self._vertices),
                vertex_labels=vlabels,
                edges=tuple((vid[s], vid[d]) for s, d, _ in self._edges),
                edge_labels=elabels,
                prec=frozenset(self._before),
            )
        except ValueError as e:
            raise PatternError(f"invalid pattern: {e}") from e
        return q, self._window

    def __repr__(self) -> str:
        edges = ", ".join(
            f"{n}:{s}->{d}" + ("" if l is None else f"[{l!r}]")
            for (s, d, l), n in zip(self._edges, self._edge_names))
        return (f"Pattern({self.name or ''} {edges} "
                f"before={sorted(self._before)} window={self._window})")
