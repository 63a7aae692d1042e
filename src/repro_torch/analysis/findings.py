"""Findings and severities: the record the plan verifier emits.

A port of the part of ``repro.analysis.findings`` that the plan verifier
needs.  Baselines and reports belong to the lint CLI, which this package
does not have yet.

Severities
----------
``error``    The plan breaks a contract the engine depends on (its
             decomposition breaks the paper's semantics).
``warning``  A hazard or a missed optimization.
``info``     Advisory (e.g. a registered query that is not in canonical
             form, so isomorphic authorings may not share a built tick).
"""

from __future__ import annotations

from dataclasses import dataclass

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    """One analysis finding."""

    pass_name: str          # "plan"
    rule: str               # e.g. "PC101"
    severity: str           # ERROR / WARNING / INFO
    path: str               # repo-relative file ("" for synthetic plans)
    line: int               # 1-based line, 0 when not line-anchored
    symbol: str             # enclosing function / plan name
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def key(self) -> tuple[str, str, str, str]:
        """Stable identity (no line number)."""
        return (self.pass_name, self.rule, self.path, self.symbol)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<plan>"
        return (f"{loc}: {self.severity} {self.rule} [{self.symbol}] "
                f"{self.message}")
