"""A whole run of a cell on the CPU at a tiny size, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not. The
run's process loads neither JAX nor the JAX package."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[1]
CELL = "siard_italy.b1m"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    small tensors on many threads each wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(monkeypatch):
    """Shrink every cell to 2,000 samples a wave at the 1e-2 quantile."""
    files = harness.cell_files

    def shrunk(name, root=harness.ROOT):
        manifest, entry, workload, config = files(name, root)
        return manifest, dict(entry, chips=1), dict(
            workload, batch=2000, quantile=0.01, warmup_posteriors=1,
            check_posteriors=2, max_waves=12), config

    monkeypatch.setattr(harness, "cell_files", shrunk)


def run(trace=False):
    return harness.run_cell(CELL, 2**31 + 17, 0.3, trace, time.time(), device_type="cpu")


def test_sound_run_is_correct(monkeypatch):
    small(monkeypatch)
    result = run(trace=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"
    assert result["metrics"]["waves_per_posterior"]["value"] >= 1


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.kernels import ops

    small(monkeypatch)
    wave = ops.AbcSim.wave

    def half(self, prior, prior_seed, sim_seed, batch, **kw):
        theta, dist = wave(self, prior, prior_seed, sim_seed, batch, **kw)
        dist[batch // 2:] = float("inf")
        return theta, dist

    monkeypatch.setattr(ops.AbcSim, "wave", half)
    result = run()
    assert not result["correct"]
    assert result["checks"]["mismatched_rows"]["value"] > 0


def test_answer_altered_where_produced(monkeypatch):
    from repro_torch.core import abc

    small(monkeypatch)
    harvest = abc.WaveRunner.harvest

    def altered(self, out, state, fill):
        harvest(self, out, state, fill)
        if state.accepted_dist:
            state.accepted_dist[0] = state.accepted_dist[0].copy()
            state.accepted_dist[0][0] *= 0.5

    monkeypatch.setattr(abc.WaveRunner, "harvest", altered)
    result = run()
    assert not result["correct"]
    assert result["checks"]["mismatched_rows"]["value"] >= 1


def test_wave_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core import abc

    small(monkeypatch)
    monkeypatch.setattr(abc, "compact_accepted",
                        lambda th, d, fill, *a: (th, d, fill))
    result = run()
    assert not result["correct"]
    assert result["failed"] > 0


def test_control_fails(monkeypatch):
    small(monkeypatch)
    manifest, entry, workload, config = harness.cell_files(CELL)
    cell = harness.make_cell(CELL, entry, workload, config)
    checks = control.readings(cell, 3, 1, torch.device("cpu"))
    assert checks["mismatched_rows"]["value"] > 0
    assert not all(c["value"] <= c["limit"] for c in checks.values())


def test_run_loads_no_jax():
    """A whole tiny run, with every metric's reader loaded, in a fresh
    process: no module whose top-level name is jax,
    jaxlib, flax or repro (`repro_torch` is not `repro`)."""
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from perfbench import harness
files = harness.cell_files
def shrunk(name, root=harness.ROOT):
    m, e, w, c = files(name, root)
    return m, e, dict(w, batch=1000, quantile=0.02, warmup_posteriors=1,
                      check_posteriors=1, max_waves=12), c
harness.cell_files = shrunk
harness.run_cell({CELL!r}, 5, 0.1, True, time.time(), device_type="cpu")
manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
for cell in manifest["workloads"]:
    for trace in (False, True):
        for name, _ in harness.cell_metrics(manifest, cell["name"], trace):
            harness.reader(name)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}]
import perfbench.reference, perfbench.counting, perfbench.control, perfbench.peaks
import perfbench.models.siard, perfbench.models.metapop_seir
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"repro_torch", "repro", "jax"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_without_result():
    """Where the card is missing the command prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""

