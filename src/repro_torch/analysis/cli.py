"""``python -m repro_torch.analysis`` — run all three passes, emit a report.

The port of ``repro.analysis.cli``, over the port's tree: the tick-scope
lint (``ast_lint``), the Hopper kernel contracts (``kernel_check``) and
the plan invariants (``plan_check``).

Exit status: 1 if any non-baselined ERROR finding remains (always), or
any non-baselined WARNING under ``--error-on-findings``.  INFO findings
never affect the exit status.  The JSON report (``--json``) uses the
``repro_analysis/v1`` schema from ``repro_torch.analysis.findings``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.findings import (
    ERROR, WARNING, Report, load_baseline)

PASSES = ("lint", "kernel", "plan")


def _default_paths():
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    pkg_root = os.path.dirname(here)                   # src/repro_torch
    repo_root = os.path.dirname(os.path.dirname(pkg_root))
    return pkg_root, os.path.join(repo_root, "analysis_baseline_torch.json")


def run_passes(root: str, passes=PASSES, fast: bool = False) -> Report:
    """Run the selected passes over the tree rooted at ``root``."""
    findings, stats = [], {}
    if "lint" in passes:
        from repro_torch.analysis.ast_lint import lint_tree
        f, s = lint_tree(root)
        findings += f
        stats.update(s)
    if "kernel" in passes:
        from repro_torch.analysis.kernel_check import check_kernels
        f, s = check_kernels(os.path.join(root, "kernels"), fast=fast)
        findings += f
        stats.update(s)
    if "plan" in passes:
        from repro_torch.analysis.plan_check import verify_corpus
        f, s = verify_corpus()
        findings += f
        stats.update(s)
    return Report(findings=findings, stats=stats)


def main(argv=None) -> int:
    default_root, default_baseline = _default_paths()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis gate: tick-scope lint, Hopper "
                    "kernel contracts, plan invariants.")
    ap.add_argument("--root", default=default_root,
                    help="package tree to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--baseline", default=default_baseline,
                    help="suppression baseline (default: repo-root "
                         "analysis_baseline_torch.json)")
    ap.add_argument("--error-on-findings", action="store_true",
                    help="also fail on non-baselined warnings")
    ap.add_argument("--fast", action="store_true",
                    help="reduced kernel-checker lattice (tests)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES, default=None,
                    help="run only this pass (repeatable)")
    args = ap.parse_args(argv)

    passes = tuple(args.passes) if args.passes else PASSES
    report = run_passes(args.root, passes=passes, fast=args.fast)
    baseline = load_baseline(args.baseline)
    report = report.split_by_baseline(baseline)

    by_sev = report.by_severity()
    for f in sorted(report.findings,
                    key=lambda f: (f.severity != ERROR, f.path, f.line)):
        print(f.format())
    print(f"repro_torch.analysis: {by_sev[ERROR]} error(s), "
          f"{by_sev[WARNING]} warning(s), {by_sev['info']} info; "
          f"{len(report.suppressed)} baselined; stats={report.stats}")

    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(report.to_json(), fh, indent=1)
            fh.write("\n")

    if by_sev[ERROR] > 0:
        return 1
    if args.error_on_findings and by_sev[WARNING] > 0:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
