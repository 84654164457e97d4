"""Static analysis of the port: the AST lint pass and the wave-loop audit
(port of `repro.analysis`).

Run both passes with `python -m repro_torch.analysis`; it exits non-zero on
any finding. `lint` checks the source of `src/repro_torch` and
`chip_smoke.py` (atomic artifact writes, host syncs in the device loops,
suppression reasons); `trace_audit` runs one device-loop segment of every
registered combination on the CPU under a dispatch recorder (float64, host
syncs a segment, buffer reuse, the campaign's shape cache).
"""

from repro_torch.analysis.lint import RULES, run_lint
from repro_torch.analysis.report import (
    SCHEMA,
    Finding,
    dump_report,
    evaluate,
    load_baseline,
    make_report,
)
from repro_torch.analysis.trace_audit import AUDIT_RULES, run_audit

__all__ = [
    "AUDIT_RULES",
    "Finding",
    "RULES",
    "SCHEMA",
    "dump_report",
    "evaluate",
    "load_baseline",
    "make_report",
    "run_audit",
    "run_lint",
]
