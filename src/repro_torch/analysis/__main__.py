"""CLI: `python -m repro_torch.analysis [--pass lint|audit|all] [--quick]
[--report f.json]`

Exit code 0 when every finding is in the baseline (none by default, so any
finding fails) and no baseline entry is stale, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.report import dump_report, evaluate, load_baseline, make_report
from repro_torch.analysis.trace_audit import run_audit


def repo_root() -> Path:
    """The checkout root (this file lives at src/repro_torch/analysis/)."""
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis: AST lint + wave-loop audit",
    )
    parser.add_argument("--pass", dest="passes", choices=("lint", "audit", "all"),
                        default="all", help="which pass to run (default: all)")
    parser.add_argument("--quick", action="store_true",
                        help="audit axis-coverage combos instead of the full cross product")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="file of allowed finding keys (default: none, every finding "
                             "fails)")
    parser.add_argument("--report", type=Path, default=None,
                        help="write the analysis-report/v1 JSON here")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    args = parser.parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis.lint import RULES
        from repro_torch.analysis.trace_audit import AUDIT_RULES

        for name, desc in {**RULES, **AUDIT_RULES}.items():
            print(f"{name:28s} {desc}")
        return 0

    findings, passes = [], []
    if args.passes in ("lint", "all"):
        passes.append("lint")
        findings.extend(run_lint(repo_root()))
    if args.passes in ("audit", "all"):
        passes.append("trace_audit")
        findings.extend(run_audit(quick=args.quick, log=print))

    report = make_report(findings, passes)
    if args.report:
        dump_report(report, args.report)
        print(f"[analysis] report -> {args.report}")
    return evaluate(load_baseline(args.baseline), findings)


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
