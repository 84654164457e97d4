"""BENCHMARK.json against the benchmark's contract: names, units and
lengths, and every file a cell needs found by name."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entry_keys_names_and_lines(group):
    entries = MANIFEST[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert line(e[k]), (e["name"], k)
        if group == "configs":
            assert line(e["source"])
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
        if group == "workloads":
            assert e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_metrics():
    names = {m["name"] for m in METRICS}
    assert len(names) == len(METRICS)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", CELLS)) <= set(moved), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_and_configs():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(CELLS) <= 24
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in MANIFEST["workloads"]} == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in MANIFEST["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from perfbench import harness

    manifest, entry, workload, config = harness.cell_files(cell)
    assert config["name"] == entry["config"]
    assert (HERE / "models" / f"{config['model']}.py").is_file()
    assert entry["chips"] == 1, "the harness runs a cell on one card"
    every = {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", CELLS)}
    assert "setup_s" in every and len(every) >= 2
    layer = harness.cell_metrics(manifest, cell, trace=True)
    assert layer
    for name, _ in harness.cell_metrics(manifest, cell, False) + layer:
        assert callable(harness.reader(name))


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_file(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    for k in ("ops_per_sample_day", "ops_per_sample", "theta", "prior_highs", "days",
              "target_accepted", "data_seed", "assumed"):
        assert k in data, k
    regions = int(data["regions"])
    for key, shape in (("mobility", (regions, regions)), ("populations", (regions,))):
        if "file" in (data.get(key) or {}):
            path = HERE / "configs" / data[key]["file"]
            assert path.is_file(), (key, path)
            arr = np.load(path, allow_pickle=False)
            assert arr.shape == shape and arr.dtype == np.float32, (key, arr.shape, arr.dtype)
