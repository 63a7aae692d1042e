"""Plan invariant verifier (``plan_check``), enforced at
``QueryRegistry.register``/``adopt`` time."""

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding
from repro_torch.analysis.plan_check import (
    PlanInvariantError, check_plan, verify_corpus, verify_plan)

__all__ = ["ERROR", "INFO", "WARNING", "Finding", "PlanInvariantError",
           "check_plan", "verify_plan", "verify_corpus"]
