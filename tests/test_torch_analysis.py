"""The port's static analysis (`repro_torch.analysis`), as
tests/test_analysis_rules.py holds `repro`'s: planted violations trip their
named rules, suppressions with a reason hold them, and the committed tree
is clean under both passes.
"""

import json
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import lint, trace_audit
from repro_torch.analysis.lint import Linter, run_lint
from repro_torch.analysis.report import SCHEMA, Finding, evaluate, load_baseline, make_report
from repro_torch.analysis.trace_audit import (
    Combo,
    DispatchRecorder,
    audit_buffers,
    audit_combo,
    audit_dtypes,
    audit_shape_cache,
    audit_syncs,
    run_audit,
    wave_buffer_allocations,
)
from repro_torch.core import abc as tabc
from repro_torch.core import distributed

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PLANTED = REPO / "src" / "repro_torch" / "_planted.py"


def lint_source(code: str, device_loops=("run",)):
    return Linter(PLANTED, REPO, source=textwrap.dedent(code), device_loops=device_loops).run()


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# lint: non-atomic-artifact-write (kept as repro's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code,n", [
    ("import numpy as np\ndef save(path, arrays):\n    np.savez(path, **arrays)\n", 1),
    ("import json\ndef save(path, p):\n    with open(path, 'w') as f:\n"
     "        json.dump(p, f)\n", 2),
    ("def save(path, text):\n    path.write_text(text)\n", 1),
    ("import pickle\ndef save(path, r):\n    with open(path, 'wb') as f:\n"
     "        pickle.dump(r, f)\n", 2),
])
def test_planted_non_atomic_writes_trip(code, n):
    findings = lint_source(code, device_loops=())
    assert rules_of(findings) == ["non-atomic-artifact-write"]
    assert len(findings) == n and findings[0].context == "save"


def test_atomic_write_handle_and_read_mode_are_clean():
    findings = lint_source("""
        import json
        import numpy as np
        from repro_torch.ioutils import atomic_write

        def save(path, payload, arrays):
            with atomic_write(path, "w") as f:
                json.dump(payload, f)
            with atomic_write(path, "wb") as g:
                np.savez(g, **arrays)

        def load(path):
            with open(path) as f:
                return json.load(f)
    """, device_loops=())
    assert findings == []


# ---------------------------------------------------------------------------
# lint: host-sync-in-wave-loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["n.item()", "n.cpu()", "n.numpy()", "n.tolist()",
                                  "torch.cuda.synchronize()", "float(n)", "int(n)",
                                  "bool(n)", "np.asarray(n)"])
def test_planted_sync_in_a_device_loop_trips(sync):
    findings = lint_source(f"""
        import numpy as np
        import torch

        def run(n, waves):
            for i in range(waves):
                n = n + 1
                {sync}
            return n
    """)
    assert rules_of(findings) == ["host-sync-in-wave-loop"]
    assert findings[0].context == "run" and findings[0].line == 8


def test_sync_outside_the_loop_body_or_of_a_literal_is_clean():
    findings = lint_source("""
        def run(n, waves):
            k = int(waves)  # before the loop: once a call
            for i in range(k):
                n = n + float(1)
            return n.item()  # after it: the loop's read
    """)
    assert findings == []


def test_unregistered_function_is_not_a_device_loop():
    findings = lint_source("""
        def harvest(out, waves):
            for i in range(waves):
                out[i].item()
    """, device_loops=())
    assert findings == []


def test_same_module_callee_of_a_loop_body_is_checked_whole():
    findings = lint_source("""
        def helper(x):
            return x.cpu()

        def other(x):
            return helper(x)

        def run(n, waves):
            for i in range(waves):
                n = other(n)
            return n
    """)
    assert rules_of(findings) == ["host-sync-in-wave-loop"]
    assert [f.context for f in findings] == ["helper"]


def test_method_of_a_registered_class_and_nested_round():
    findings = lint_source("""
        class Runner:
            def __call__(self, n, waves):
                for i in range(waves):
                    n = n + n.sum().item()
                return n

        def make_round():
            def round_fn(n):
                while n < 3:
                    n = int(n)
                return n
            return round_fn
    """, device_loops=("Runner.__call__", "make_round.round_fn"))
    assert sorted(f.context for f in findings) == ["Runner.__call__", "make_round.round_fn"]


def test_imported_callee_of_another_module_is_checked(tmp_path):
    a = "from repro_torch.b import read\n\ndef run(n, w):\n    for i in range(w):\n" \
        "        n = read(n)\n    return n\n"
    b = "def read(n):\n    return int(n)\n"
    project = lint._Project({"src/repro_torch/a.py": a, "src/repro_torch/b.py": b},
                            {"src/repro_torch/a.py": ("run",)})
    found = {rel: Linter(REPO / rel, REPO, source=src, project=project).run()
             for rel, src in (("src/repro_torch/a.py", a), ("src/repro_torch/b.py", b))}
    assert found["src/repro_torch/a.py"] == []
    assert rules_of(found["src/repro_torch/b.py"]) == ["host-sync-in-wave-loop"]
    assert found["src/repro_torch/b.py"][0].context == "read"


def test_a_registered_loop_that_is_gone_is_a_finding():
    findings = lint_source("def other():\n    pass\n", device_loops=("run",))
    assert rules_of(findings) == ["host-sync-in-wave-loop"]
    assert "not in the file" in findings[0].message


def test_every_registered_device_loop_exists():
    for rel, quals in lint.DEVICE_LOOPS.items():
        module = lint._Module(rel, (REPO / rel).read_text())
        for qual in quals:
            assert qual in module.functions, f"{rel}: {qual}"


# ---------------------------------------------------------------------------
# lint: suppression machinery
# ---------------------------------------------------------------------------

def test_suppression_with_reason_suppresses():
    findings = lint_source("""
        def run(n, waves):
            for i in range(waves):
                # analysis: allow(host-sync-in-wave-loop) — a planted read
                # that the test sanctions
                n = int(n)
            return n
    """)
    assert findings == []


def test_suppression_without_reason_trips_its_own_rule():
    findings = lint_source("""
        import numpy as np

        def save(tmp, arr):
            # analysis: allow(non-atomic-artifact-write)
            np.savez(tmp, arr=arr)
    """, device_loops=())
    assert rules_of(findings) == ["suppression-missing-reason"]


def test_suppression_for_other_rule_does_not_suppress():
    findings = lint_source("""
        def run(n, waves):
            for i in range(waves):
                # analysis: allow(non-atomic-artifact-write) — wrong rule
                n = n.item()
            return n
    """)
    assert rules_of(findings) == ["host-sync-in-wave-loop"]


def test_sync_counts_carries_the_one_sanctioned_suppression():
    text = (REPO / "src/repro_torch/core/abc.py").read_text()
    start = text.index("def sync_counts")
    body = text[start:text.index("\ndef ", start + 1)]
    assert "analysis: allow(host-sync-in-wave-loop) —" in body
    # without its suppression the lint would flag it: it is in a loop's reach
    bare = body.replace("allow(host-sync-in-wave-loop)", "allow(none)")
    project = lint._Project({"src/repro_torch/core/abc.py": text.replace(body, bare)},
                            {"src/repro_torch/core/abc.py": ("run",)})
    assert "sync_counts" not in project.wave_fns["src/repro_torch/core/abc.py"]
    smc = (REPO / "src/repro_torch/core/smc.py").read_text()
    project = lint._Project({"src/repro_torch/core/abc.py": text.replace(body, bare),
                             "src/repro_torch/core/smc.py": smc})
    assert "sync_counts" in project.wave_fns["src/repro_torch/core/abc.py"]
    found = Linter(REPO / "src/repro_torch/core/abc.py", REPO,
                   source=text.replace(body, bare), project=project).run()
    assert {f.context for f in found} == {"sync_counts"}


# ---------------------------------------------------------------------------
# trace audit: planted violations through the pure checkers
# ---------------------------------------------------------------------------

def _recorded(fn, *args):
    rec = DispatchRecorder()
    with rec:
        fn(*args)
    return rec.events


def test_planted_float64_leak_trips():
    events = _recorded(lambda x: (x.double() * 2).float(), torch.ones(4))
    assert rules_of(audit_dtypes(events, "planted/f64")) == ["f64-promotion"]
    clean = _recorded(lambda x: torch.sin(x) + 1.0, torch.ones(4))
    assert audit_dtypes(clean, "clean") == []


def test_planted_extra_item_in_a_segment_trips():
    def segment(n):
        n = n + 1
        n.item()  # a stray read beside the count read
        return tabc.sync_counts(n)

    syncs0 = tabc.HOST_SYNCS
    events = _recorded(segment, torch.zeros((1,), dtype=torch.int64))
    reads = tabc.HOST_SYNCS - syncs0
    assert reads == 1
    assert rules_of(audit_syncs(events, reads, 1, "planted/item")) == ["host-sync-in-segment"]
    # the count read alone, however many counts it copies, is one sync
    syncs0 = tabc.HOST_SYNCS
    events = _recorded(lambda a, b: tabc.sync_counts(a, b), torch.zeros((1,), dtype=torch.int64),
                       torch.ones((2,), dtype=torch.int64))
    assert [e.scope for e in events if e.sync] == ["read"] * 3
    assert audit_syncs(events, tabc.HOST_SYNCS - syncs0, 1, "clean") == []


def test_planted_reallocated_buffer_trips():
    batch, width = 16, 3

    def waves(n, realloc):
        buf = torch.zeros((batch,))
        for _ in range(n):
            if realloc:
                buf = torch.zeros((batch,))  # a new wave buffer every wave
            buf.add_(1.0)

    allocs = {n: wave_buffer_allocations(_recorded(waves, n, True), batch, width)
              for n in (1, 3)}
    assert rules_of(audit_buffers([(1, 2), (1, 2)], allocs, "planted/alloc")) == [
        "buffer-not-reused"]
    kept = {n: wave_buffer_allocations(_recorded(waves, n, False), batch, width)
            for n in (1, 3)}
    assert kept == {1: 1, 3: 1}
    assert audit_buffers([(1, 2), (1, 2)], kept, "clean") == []
    assert rules_of(audit_buffers([(1, 2), (5, 2)], kept, "planted/moved")) == [
        "buffer-not-reused"]


def test_planted_shape_cache_retrace_trips():
    a = {"obs": torch.zeros((3, 21)), "width": 8}
    b = {"obs": torch.zeros((3, 28)), "width": 8}  # shape drift
    assert rules_of(audit_shape_cache([a, b], "planted/retrace")) == ["shape-cache-retrace"]
    assert rules_of(audit_shape_cache([a, a], "planted/entries", entries=2)) == [
        "shape-cache-retrace"]
    c = {"obs": torch.ones((3, 21)), "width": 8}  # values only
    assert audit_shape_cache([a, c], "clean") == []


# ---------------------------------------------------------------------------
# trace audit: the real wave loop with a planted fault
# ---------------------------------------------------------------------------

COMBO = Combo("sir", None, "euclidean", 0)
#: the pjit device loop (`core.distributed.PjitWaveRunner`, a world of 1)
PJIT_COMBO = Combo("sir", None, "euclidean", 0, style="pjit")


@pytest.mark.parametrize("combo,fault,rule", [
    (COMBO, "item", "host-sync-in-segment"),
    (COMBO, "float64", "f64-promotion"),
    (COMBO, "copy", "buffer-not-reused"),
    (PJIT_COMBO, "item", "host-sync-in-segment"),
    (PJIT_COMBO, "float64", "f64-promotion"),
], ids=["item", "float64", "copy", "pjit-item", "pjit-float64"])
def test_audit_catches_a_fault_planted_in_the_wave_loop(monkeypatch, combo, fault, rule):
    real = tabc.compact_accepted

    def planted(th_buf, d_buf, fill, theta, dist, accept, capacity):
        if fault == "item":
            accept.sum().item()
        elif fault == "float64":
            accept.sum().double()
        th_buf, d_buf, new_fill = real(th_buf, d_buf, fill, theta, dist, accept, capacity)
        if fault == "copy":
            th_buf, d_buf = th_buf.clone(), d_buf.clone()
        return th_buf, d_buf, new_fill

    monkeypatch.setattr(tabc, "compact_accepted", planted)
    monkeypatch.setattr(distributed, "compact_accepted", planted)
    assert rules_of(audit_combo(combo, batch=64, num_days=6)) == [rule]


def test_pjit_loop_audits_clean_with_one_sync_a_segment():
    """The pjit combo runs its count all-reduce a wave and its gather and
    placement at the host re-entry under the audit: no finding, and the
    registered grids carry it, flat and on the region axis."""
    assert audit_combo(PJIT_COMBO, batch=64, num_days=6) == []
    for quick in (True, False):
        pjit = sorted(c.tag for c in trace_audit.registered_combos(quick=quick)
                      if c.style == "pjit")
        assert pjit == ["metapop_seir/identity/euclidean/sched0/r3/pjit",
                        "siard/identity/euclidean/sched0/pjit"]


def test_audit_catches_a_wave_that_allocates_its_buffers(monkeypatch):
    real = tabc.WaveRunner.__call__

    def fresh_scratch(self, seed, run_idx0, carry, max_waves):
        out = None
        for i in range(max_waves):  # one call a wave: scratch made every wave
            out = real(self, seed, run_idx0 + i, carry, 1)
            carry = self.carry_of(out)
        return out._replace(waves_done=out.waves_done, enqueued=max_waves)

    monkeypatch.setattr(tabc.WaveRunner, "__call__", fresh_scratch)
    assert "buffer-not-reused" in rules_of(audit_combo(COMBO, batch=64, num_days=6))


def test_audit_reports_a_combo_that_cannot_run():
    found = audit_combo(Combo("sir", "no_such_summary", "euclidean", 0))
    assert rules_of(found) == ["audit-trace-error"]


def test_registered_combos_cover_every_axis():
    from repro_torch.core.summaries import DISTANCE_KINDS, list_summaries
    from repro_torch.epi.models import list_models

    quick = trace_audit.registered_combos(quick=True)
    assert {c.model for c in quick} == set(list_models())
    assert {c.summary or "identity" for c in quick} == set(list_summaries())
    assert {c.distance for c in quick} == set(DISTANCE_KINDS)
    assert {c.sched_shape for c in quick} == {0, 2}
    assert {c.regions for c in quick} == {1, 3}
    full = trace_audit.registered_combos()
    assert set(quick) <= set(full) and len(full) > len(quick)


# ---------------------------------------------------------------------------
# the gate decision (pure) + report schema
# ---------------------------------------------------------------------------

def _finding(rule="non-atomic-artifact-write", ctx="save"):
    return Finding(rule=rule, path="src/repro_torch/x.py", line=3, context=ctx,
                   message="planted")


def test_gate_decisions():
    f = _finding()
    assert evaluate(set(), [f]) == 1
    assert evaluate({f.key}, [f]) == 0
    assert evaluate({"host-sync-in-wave-loop:src/repro_torch/gone.py:fn"}, []) == 1
    assert evaluate(set(), []) == 0


def test_report_schema_and_keys(tmp_path):
    f = _finding()
    report = make_report([f], ["lint"])
    assert report["schema"] == SCHEMA == "analysis-report/v1"
    assert report["counts"] == {"total": 1, "by_rule": {"non-atomic-artifact-write": 1}}
    assert report["findings"][0]["key"] == f.key
    b = tmp_path / "baseline.txt"
    b.write_text(f"# comment\n{f.key}\n")
    assert load_baseline(b) == {f.key}
    assert load_baseline(tmp_path / "missing.txt") == set()
    path = analysis.dump_report(report, tmp_path / "r.json")
    assert json.loads(path.read_text()) == report


def test_rule_catalogs():
    assert set(analysis.RULES) == {"non-atomic-artifact-write", "host-sync-in-wave-loop",
                                   "suppression-missing-reason"}
    assert set(analysis.AUDIT_RULES) == {"f64-promotion", "host-sync-in-segment",
                                         "buffer-not-reused", "shape-cache-retrace",
                                         "audit-trace-error"}


# ---------------------------------------------------------------------------
# the committed tree is clean
# ---------------------------------------------------------------------------

def test_committed_tree_lints_clean():
    findings = run_lint(REPO)
    assert findings == [], "\n".join(str(f) for f in findings)
    scope = {str(p.relative_to(REPO)) for p in lint.default_targets(REPO)}
    assert "chip_smoke.py" in scope and "src/repro_torch/core/abc.py" in scope


def test_committed_tree_audits_clean_quick():
    findings = run_audit(quick=True)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_lint_pass_and_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli.main(["--pass", "lint", "--report", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["passes"] == ["lint"] and report["counts"]["total"] == 0
    assert cli.main(["--list-rules"]) == 0
    assert "host-sync-in-wave-loop" in capsys.readouterr().out
