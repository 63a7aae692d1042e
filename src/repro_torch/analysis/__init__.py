"""Static analysis gate for the port (``python -m repro_torch.analysis``).

Three passes, one findings currency:

* ``ast_lint``     — tick-scope linter: host syncs, host-built tensors and
  instrumentation reachable from a tick or a kernel wrapper;
* ``kernel_check`` — the Hopper kernels' launch contracts (grids, cover,
  granules, shared memory, int extents, the plan/source ABI, the pair
  cursor) proven over the reachable shape lattice, plus each wrapper's
  outputs against its plain version;
* ``plan_check``   — the paper's decomposition invariants, also enforced
  at ``QueryRegistry.register`` time via ``verify_plan``.
"""

from repro_torch.analysis.findings import (
    ERROR, INFO, SEVERITIES, WARNING, Baseline, Finding, Report,
    load_baseline)
from repro_torch.analysis.plan_check import (
    PlanInvariantError, check_plan, verify_corpus, verify_plan)

__all__ = [
    "ERROR", "INFO", "WARNING", "SEVERITIES",
    "Baseline", "Finding", "Report", "load_baseline",
    "PlanInvariantError", "check_plan", "verify_plan", "verify_corpus",
]
