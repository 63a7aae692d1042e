"""Typed stream records for the public API: events in, matches out.

The engine speaks dense ``int32`` label ids and padded ``EdgeBatch``
arrays; tenants speak domain tokens ("login", "xfer") and individual
timestamped events.  This module is the boundary:

* ``LabelVocab``   interns str/int label tokens into the id space the
  engine compares — ints identity-mapped, strings from ``STR_BASE`` up
  (checkpoint-serializable, so a restored session keeps speaking the
  same tokens, and raw ``DataEdge`` streams stay aligned with
  int-labeled patterns);
* ``Event``        one typed stream edge with an explicit timestamp;
* ``Match``        one reported match, bindings keyed by the pattern's
  vertex/edge *names* (hashable, so differential tests can treat match
  streams as multisets);
* ``EventBuffer``  batches events into the service's power-of-two padded
  chunk shapes (``quantize_pow2``) so ad-hoc ingest sizes produce a
  bounded set of batch shapes.

The port of ``repro.api.events``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.oracle import DataEdge
from repro_torch.runtime.straggler import quantize_pow2

#: Vocabulary token carried by vertices/events that declare no label.
#: A pattern vertex without a label only matches unlabeled endpoints —
#: the engine has no vertex-label wildcard (edge labels DO have one:
#: a pattern edge with ``label=None`` matches any event label).
UNLABELED = "__unlabeled__"

#: String tokens intern at ids >= STR_BASE; integer tokens map to
#: THEMSELVES.  This keeps raw ``DataEdge`` streams (already in engine
#: label space, passed through untouched) exactly aligned with
#: int-labeled patterns — without identity mapping, ``label=2`` could
#: intern to engine id 0 depending on declaration order and raw streams
#: would silently compare mismatched ids.
STR_BASE = 1 << 20


class LabelVocab:
    """Label-token interning (JSON round-trippable).

    One vocab is shared by every pattern and every event of a session,
    so "login" means the same engine id on both sides.  Integer tokens
    ARE their engine id (identity — see ``STR_BASE``); string tokens get
    dense ids from ``STR_BASE`` up, so the two ranges never collide.
    Tokens must be ``str`` or non-negative ``int < STR_BASE`` — the
    vocab is persisted inside the checkpoint manifest, and negative ints
    would collide with the engine's edge-label wildcard (-1).
    """

    def __init__(self, tokens=()):
        self._ids: dict = {}
        self._tokens: list = []      # str tokens, id = STR_BASE + index
        for t in tokens:
            self.intern(t)

    def intern(self, token) -> int:
        if isinstance(token, bool) or not isinstance(token, (str, int)):
            raise TypeError(
                f"label tokens must be str or int, got {token!r} "
                "(they are persisted in checkpoint manifests)")
        if isinstance(token, int):
            if not 0 <= token < STR_BASE:
                raise ValueError(
                    f"int label tokens must be in [0, {STR_BASE}), got "
                    f"{token} (negative collides with the wildcard, "
                    "larger with the string-token range)")
            return token
        lid = self._ids.get(token)
        if lid is None:
            lid = STR_BASE + len(self._tokens)
            self._ids[token] = lid
            self._tokens.append(token)
        return lid

    def token(self, lid: int):
        return self._tokens[lid - STR_BASE] if lid >= STR_BASE else lid

    def __len__(self) -> int:
        return len(self._tokens)

    def __contains__(self, token) -> bool:
        if isinstance(token, int) and not isinstance(token, bool):
            return 0 <= token < STR_BASE
        return token in self._ids

    def to_json(self) -> list:
        return list(self._tokens)

    @classmethod
    def from_json(cls, tokens: list) -> "LabelVocab":
        return cls(tokens)


class Event(NamedTuple):
    """One stream edge: ``src --label--> dst`` at time ``ts``.

    ``src``/``dst`` are the caller's integer vertex ids; labels are
    vocab tokens (str or int) or ``None`` for unlabeled.
    """

    src: int
    dst: int
    ts: int
    label: object = None
    src_label: object = None
    dst_label: object = None


def to_data_edge(event, vocab: LabelVocab) -> DataEdge:
    """Lower an ``Event`` into engine space; ``DataEdge``s pass through
    untouched (they are already in engine label space)."""
    if isinstance(event, DataEdge):
        return event
    return DataEdge(
        src=int(event.src), dst=int(event.dst), ts=int(event.ts),
        src_label=vocab.intern(
            UNLABELED if event.src_label is None else event.src_label),
        dst_label=vocab.intern(
            UNLABELED if event.dst_label is None else event.dst_label),
        edge_label=vocab.intern(
            UNLABELED if event.label is None else event.label),
    )


def as_source(name: str, events, vocab: LabelVocab):
    """Lower a list of typed ``Event``s (or raw ``DataEdge``s) into a
    resumable ``repro_torch.stream.ingest.ListSource`` for the ingestion
    frontier — the session-side source registration hook
    (``StreamSession.sources``).  The vocab translation happens here,
    once, so the frontier and engine speak dense ids only."""
    from repro_torch.stream.ingest import ListSource
    return ListSource(name, [to_data_edge(e, vocab) for e in events])


class Match(NamedTuple):
    """One reported match, in the pattern's own vocabulary.

    ``vertices``: ``(vertex_name, data_vertex_id)`` pairs in authoring
    order; ``edges``: ``(edge_name, matched_edge_timestamp)`` pairs in
    authoring order.  NamedTuple of tuples → hashable, so match streams
    form multisets (``collections.Counter``) in differential tests.
    """

    vertices: tuple
    edges: tuple

    @property
    def bindings(self) -> dict:
        """``{vertex_name: data_vertex_id}``."""
        return dict(self.vertices)

    @property
    def times(self) -> dict:
        """``{edge_name: timestamp}`` of the matched stream edges."""
        return dict(self.edges)

    @property
    def ts(self) -> int:
        """Completion time: the newest matched edge's timestamp."""
        return max(t for _, t in self.edges)


class EventBuffer:
    """Batches events into the service's padded pow-2 chunk dicts.

    ``push`` returns a ready batch every ``batch_size`` events (``None``
    otherwise); ``flush`` pads the tail.  Every emitted chunk is padded
    to ``quantize_pow2`` length, so a session ingesting arbitrary-sized
    event lists still presents a bounded set of batch shapes to the
    slot ticks.
    """

    def __init__(self, vocab: LabelVocab, batch_size: int = 64):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.vocab = vocab
        self.batch_size = batch_size
        self._pending: list[DataEdge] = []

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, event) -> dict | None:
        self._pending.append(to_data_edge(event, self.vocab))
        if len(self._pending) >= self.batch_size:
            return self.flush()
        return None

    def flush(self) -> dict | None:
        """Emit the pending tail as one padded batch dict (or ``None``)."""
        if not self._pending:
            return None
        chunk, self._pending = self._pending, []
        width = quantize_pow2(len(chunk))
        pad = width - len(chunk)
        get = lambda f: np.array(
            [getattr(e, f) for e in chunk] + [0] * pad, np.int32)
        return dict(
            src=get("src"), dst=get("dst"), ts=get("ts"),
            src_label=get("src_label"), dst_label=get("dst_label"),
            edge_label=get("edge_label"),
            valid=np.array([True] * len(chunk) + [False] * pad),
        )
