"""Finding/report containers shared by both analysis passes (port of
`repro.analysis.report`).

Everything the passes emit funnels through one `Finding` shape, so that the
CLI (`python -m repro_torch.analysis`), its tests and `chip_smoke.py` speak
the same `analysis-report/v1` JSON as `repro`:

    {
      "schema": "analysis-report/v1",
      "passes": ["lint", "trace_audit"],
      "counts": {"total": N, "by_rule": {...}},
      "findings": [
        {"rule": ..., "path": ..., "line": ..., "context": ...,
         "message": ..., "key": "rule:path:context"},
        ...
      ]
    }

`key` is the identity a baseline entry matches on. It deliberately omits
the line number (stable across unrelated edits drifting a file's lines)
but keeps the enclosing context — a function name for lint findings, a
combo tag like `seir/weekly/mae/sched2` for audit findings — so two
distinct violations of one rule in one file stay distinct entries.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

SCHEMA = "analysis-report/v1"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str  # registry name, e.g. "non-atomic-artifact-write"
    path: str  # repo-relative file ("-" for audit findings with no file)
    line: int  # 1-based line (0 when not applicable)
    context: str  # enclosing function / combo tag — part of the baseline key
    message: str  # human-readable detail

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.context}"

    def to_json(self) -> Dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "context": self.context,
            "message": self.message,
            "key": self.key,
        }

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"[{self.rule}] {loc} ({self.context}): {self.message}"


def make_report(
    findings: Iterable[Finding], passes: Iterable[str]
) -> Dict:
    """Assemble the analysis-report/v1 payload (pure, JSON-serializable)."""
    findings = list(findings)
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "schema": SCHEMA,
        "passes": sorted(passes),
        "counts": {"total": len(findings), "by_rule": by_rule},
        "findings": [f.to_json() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.rule)
        )],
    }


def dump_report(report: Dict, path: str | Path) -> Path:
    from repro_torch.ioutils import atomic_write_text

    return atomic_write_text(path, json.dumps(report, indent=1, sort_keys=True))


def load_baseline(path: Optional[str | Path]) -> set:
    """Baseline keys, one per line, '#' comments.

    A missing file means an empty baseline (zero allowed findings), NOT an
    error: the healthy steady state is no baseline entries at all.
    """
    if path is None or not Path(path).exists():
        return set()
    known = set()
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            known.add(line)
    return known


def evaluate(
    known: set, findings: List[Finding], *, log=print
) -> int:
    """Pure gate decision: findings + baseline keys -> exit code.

    Any finding whose key is not in the baseline fails; a baseline entry
    matching no finding is STALE and also fails (an already-fixed violation
    must not stay allowlisted where it could silently regress). The port
    keeps no baseline: every finding fails.
    """
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in known]
    stale = known - keys
    rc = 0
    if new:
        log(f"[analysis] {len(new)} finding(s) beyond the baseline:")
        for f in sorted(new, key=lambda f: f.key):
            log(f"  {f}")
        rc = 1
    if stale:
        log("[analysis] STALE: baseline entries match no finding — "
            "delete them from the baseline file:")
        for k in sorted(stale):
            log(f"  {k}")
        rc = 1
    if rc == 0:
        log(f"[analysis] OK: {len(findings)} finding(s), all in the "
            f"baseline ({len(known)} entries)")
    return rc
