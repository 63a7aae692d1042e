"""repro_torch.api — the public, declarative surface of the system.

Users state timing-constrained patterns and continuously receive typed
matches from the edge stream; everything else (canonicalization,
slot-group packing, compiled-tick caching, coalescing, checkpoints) is
the machinery underneath:

    Pattern        fluent pattern DSL (edges, before-constraints, window)
    StreamSession  register -> Subscription -> ingest/serve -> restore
    Event / Match  typed stream records (label tokens, named bindings)

``repro_torch.runtime.service`` stays the internal engine room — new
code should import from here.  The port of ``repro.api``; a session runs
on the card unless it is given ``device="cpu"``.
"""

from repro_torch.api.events import (
    STR_BASE,
    UNLABELED,
    Event,
    EventBuffer,
    LabelVocab,
    Match,
    to_data_edge,
)
from repro_torch.api.pattern import Pattern, PatternError
from repro_torch.api.planner import PatternPlan, compile_pattern
from repro_torch.api.session import (
    ACTIVE,
    CLOSED,
    DEGRADED,
    AdmissionError,
    SessionStatus,
    StreamSession,
    Subscription,
)

__all__ = [
    "ACTIVE",
    "AdmissionError",
    "CLOSED",
    "DEGRADED",
    "Event",
    "EventBuffer",
    "LabelVocab",
    "Match",
    "Pattern",
    "PatternError",
    "PatternPlan",
    "STR_BASE",
    "SessionStatus",
    "StreamSession",
    "Subscription",
    "UNLABELED",
    "compile_pattern",
    "to_data_edge",
]
