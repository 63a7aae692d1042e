"""Findings, severities, baselines: the shared currency of all passes.

The port of ``repro.analysis.findings``.  Every analysis pass of the
port (``ast_lint``, ``kernel_check``, ``plan_check``) emits a flat list
of ``Finding`` records.  A finding is identified for baseline purposes
by its *stable key* — pass, rule, file, and enclosing symbol —
deliberately excluding the line number, so unrelated edits that shift
lines do not invalidate suppressions.

Severities
----------
``error``    Violates a contract the stack depends on (a host sync or a
             host-built tensor inside the tick, a launch grid or shared
             memory request the card refuses, an out-of-range index, or
             a plan whose decomposition breaks the paper's semantics).
             The gate fails on any non-baselined error; the shipped
             baseline must contain none (enforced by ``load_baseline``).
``warning``  A hazard or a missed optimization (e.g. a tick that copies
             a whole table where it could update it in place).  Fails
             the gate only under ``--error-on-findings``; may be
             baselined with a written justification.
``info``     Advisory (e.g. a registered query that is not in canonical
             form, so isomorphic authorings may not share a built tick).
             Never fails the gate and needs no baseline entry.

Suppression
-----------
Two mechanisms, both requiring an explicit trace:

* inline: a ``# analysis: ignore[RULE]`` comment on the flagged line
  (handled by ``ast_lint``; line-targeted hazards only);
* baseline: an entry in the repo-root ``analysis_baseline_torch.json``
  with a non-empty ``justification`` string, matched by stable key.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    """One analysis finding."""

    pass_name: str          # "lint" | "kernel" | "plan"
    rule: str               # e.g. "TRC101"
    severity: str           # ERROR / WARNING / INFO
    path: str               # repo-relative file ("" for synthetic plans)
    line: int               # 1-based line, 0 when not line-anchored
    symbol: str             # enclosing function / kernel / plan name
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def key(self) -> tuple[str, str, str, str]:
        """Stable identity used for baseline matching (no line number)."""
        return (self.pass_name, self.rule, self.path, self.symbol)

    def to_json(self) -> dict:
        return {
            "pass": self.pass_name,
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
        }

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<plan>"
        return (f"{loc}: {self.severity} {self.rule} [{self.symbol}] "
                f"{self.message}")


@dataclass
class Baseline:
    """Parsed baseline file: keyed suppressions."""

    entries: dict[tuple, str] = field(default_factory=dict)  # key -> why
    path: str = ""

    def suppresses(self, f: Finding) -> bool:
        return f.key in self.entries


def load_baseline(path: str) -> Baseline:
    """Load a baseline file; absent file = empty baseline.

    Enforces the shipping contract: every entry names a justification,
    and no entry may suppress an ERROR-severity finding (errors must be
    fixed, not baselined).
    """
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return Baseline(path=path)
    entries: dict[tuple, str] = {}
    for ent in doc.get("suppressions", []):
        why = ent.get("justification", "").strip()
        if not why:
            raise ValueError(
                f"baseline entry {ent} has no justification "
                f"(required for every suppression)")
        if ent.get("severity") == ERROR:
            raise ValueError(
                f"baseline entry {ent} suppresses an error-severity "
                f"finding; errors must be fixed, not baselined")
        key = (ent["pass"], ent["rule"], ent["path"], ent["symbol"])
        entries[key] = why
    return Baseline(entries=entries, path=path)


@dataclass
class Report:
    """Aggregated output of an analysis run."""

    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def split_by_baseline(self, baseline: Baseline) -> "Report":
        live = [f for f in self.findings if not baseline.suppresses(f)]
        gone = [f for f in self.findings if baseline.suppresses(f)]
        return Report(findings=live, suppressed=self.suppressed + gone,
                      stats=dict(self.stats))

    def by_severity(self) -> dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def to_json(self) -> dict:
        return {
            "schema": "repro_analysis/v1",
            "stats": self.stats,
            "findings_by_severity": self.by_severity(),
            "findings": [f.to_json() for f in sorted(
                self.findings, key=lambda f: (f.path, f.line, f.rule))],
            "suppressed": [f.to_json() for f in sorted(
                self.suppressed, key=lambda f: (f.path, f.line, f.rule))],
        }
