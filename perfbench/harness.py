"""One run of one cell: set-up, the measured window, the metrics and the
check against the plain reference.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its configuration
(`perfbench/configs/<config>.json`) fixes the model, the observed series and
the prior; its own file (`perfbench/workloads/<cell>.json`) fixes the closed
loop: the batch a wave and the pilot quantile of the tolerance;
`BENCHMARK.json` gives its chips. The metrics that it lists
for the cell are each read by `perfbench/metrics/<metric>.py`.

The loop is one modeller's: posteriors of `target_accepted` samples back to
back, posterior i at a seed that is a function of `--seed` and i alone, on
`repro_torch.core.abc.run_abc` with the wave runner made once in set-up.
The observed series and the tolerance's pilot come from the configuration's
and the cell's fixed seeds, so that every `--seed` gives the same series and
the same tolerance and changes only which posteriors are drawn.

A run drives one card. A cell of more cards needs a rank path (a process a
card, every rank running the same posteriors); none is here yet.

After the window the program's state is freed and the reference
(`perfbench/reference.py`) works out again, on the run's card, the pilot's
tolerance and a sample of the window's posteriors (the one of most waves and
others drawn from the seed), and holds the program to them bit for bit.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the benchmark's process may never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: hash streams of the run's seeds (`reference.stream_seed`)
WINDOW_STREAM, WARMUP_STREAM, CHECK_STREAM = 101, 102, 103
#: each compared number's limit: the kernels are bitwise their plain
#: arithmetic, so every comparison is exact
LIMITS = {"tolerance_gap": 0.0, "mismatched_rows": 0, "waves_gap": 0}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's entry there, its workload file, its
    configuration file)."""
    manifest = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    return (manifest, entry, load_json(HERE / "workloads" / f"{name}.json"),
            load_json(HERE / "configs" / f"{entry['config']}.json"))


def cell_metrics(manifest: dict, cell: str, trace: bool):
    """[(name, unit)] that the cell reports: its per-layer metrics when
    traced, else its end-to-end ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """`read(run)` of `perfbench/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_seed(seed: int, i: int, stream: int) -> int:
    """The 32-bit seed of item i of `stream` under a `--seed` of any size."""
    from perfbench.reference import MASK32, stream_seed

    seed = int(seed) % (1 << 64)
    base = stream_seed(seed & MASK32, (seed >> 32) & MASK32, stream)
    return stream_seed(base, i, stream)


def process_start() -> float:
    """This process's start on the wall clock (from /proc), or now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + start / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclasses.dataclass
class Cell:
    """What set-up makes of the files: the series and the sizes."""

    name: str
    config: dict
    workload: dict
    observed: np.ndarray

    @property
    def batch(self) -> int:
        """Samples a wave."""
        return int(self.workload["batch"])

    @property
    def n_pilot(self) -> int:
        return int(math.ceil(100.0 / float(self.workload["quantile"])))

    @property
    def max_waves(self) -> int:
        return int(self.workload["max_waves"])


def make_cell(name: str, entry: dict, workload: dict, config: dict) -> Cell:
    from perfbench import reference as ref

    model = ref.Model(config)
    obs = ref.observed_series(model, config["theta"], config["data_seed"])
    if int(entry["chips"]) != 1:
        raise ValueError(f"{name}: the harness runs a cell on one card; it asks for "
                         f"{entry['chips']}")
    return Cell(name, config, workload, obs)


# --------------------------------------------------------------------------
# the program's side
# --------------------------------------------------------------------------

def program_spec(config: dict):
    """The program's model of a configuration: its registered model; where
    that is regional or the configuration has regions, taken to the
    configuration's regions, mobility (a ring as the program's own
    `ring:eps`, a file's matrix as it is) and seeded region; with the
    configuration's prior box; then handed to the model file's
    `program_spec(config, spec)` hook, where it has one."""
    from perfbench import reference as ref
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize

    model = ref.Model(config)
    spec = get_model(config["model"])
    if model.n_regions > 1 or spec.is_regional:
        mob = config.get("mobility") or {}
        spec = regionalize(spec, model.n_regions,
                           f"ring:{mob['ring']}" if "ring" in mob else model.mobility,
                           seed_region=model.seed_region)
    spec = dataclasses.replace(spec, prior_lows=tuple(model.lows),
                               prior_highs=tuple(model.highs))
    hook = getattr(model.rows, "program_spec", None)
    return spec if hook is None else hook(config, spec)


def make_program(cell: Cell, device):
    """(dataset, config, wave runner, the entry's C name) on `device`, the
    tolerance at the cell's pilot quantile."""
    from repro_torch.core import abc
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.data import CountryData

    c, w = cell.config, cell.workload
    spec = program_spec(c)
    ds = CountryData(name=c["name"], population=c["population"], a0=c["a0"], r0=c["r0"],
                     d0=c["d0"], observed=cell.observed, model=spec.name,
                     observed_channels=spec.observed_labels)
    cfg = abc.ABCConfig(batch_size=cell.batch, chunk_size=cell.batch,
                        target_accepted=int(c["target_accepted"]), max_runs=cell.max_waves,
                        model=spec, num_days=int(c["days"]), summary=c["summary"],
                        distance=c["distance"], wave_loop="device")
    sim = abc.make_simulator(ds, cfg, device)
    tol = abc.calibrate_tolerance(ds, cfg, seed=int(w["pilot_seed"]),
                                  quantile=float(w["quantile"]), n_pilot=cell.n_pilot,
                                  simulator=sim)
    cfg = dataclasses.replace(cfg, tolerance=tol)
    runner = abc.make_wave_runner(schedule_prior(spec), sim, cfg)
    return ds, cfg, runner, sim.entry("wave", cell.batch)


def counters(entry: str) -> dict:
    from repro_torch.core import abc
    from repro_torch.kernels import abc_sim

    return {"host_syncs": abc.HOST_SYNCS, "launches": abc_sim.ENTRY_LAUNCHES.get(entry, 0),
            "gated": abc_sim.ENTRY_GATED.get(entry, 0)}


def window(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, the warm-up posteriors and the measured window."""
    import torch

    from perfbench import trace as tr
    from repro_torch.core import abc
    from repro_torch.kernels import build

    if device.type == "cuda":
        build.build_all()
    ds, cfg, runner, entry = make_program(cell, device)
    for i in range(int(cell.workload["warmup_posteriors"])):
        abc.run_abc(ds, cfg, seed=run_seed(seed, i, WARMUP_STREAM), wave_runner=runner)
    spans = tr.Spans() if trace else None
    wave_runner = tr.SpannedRunner(runner, spans) if trace else runner
    prof = None
    if trace and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = counters(entry)
    if prof is not None:
        prof.start()
    posts = []
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while time.perf_counter() < end:
        s = run_seed(seed, i, WINDOW_STREAM)
        a_ns, a = time.time_ns(), time.perf_counter()
        post = abc.run_abc(ds, cfg, seed=s, wave_runner=wave_runner)
        b = time.perf_counter()
        if spans is not None:
            spans.record(0, "posterior", a_ns, time.time_ns())
        posts.append({"seed": s, "ms": (b - a) * 1e3, "end_s": b - t0, "runs": int(post.runs),
                      "accepted": int(post.theta.shape[0]), "theta": post.theta,
                      "dist": post.distances})
        i += 1
    t1 = time.perf_counter()
    t1_ns = time.time_ns()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary = None
    if prof is not None:
        prof.stop()
        summary = tr.summarize(tr.device_intervals(prof, t0_ns, t1_ns), t0_ns, t1_ns, spans)
        del prof
    after = counters(entry)
    out = {"posteriors": posts, "window_s": t1 - t0, "window_start": t0_ns / 1e9,
           "tolerance": float(cfg.tolerance),
           "counters": {k: after[k] - before[k] for k in after}, "trace": summary,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    del runner, wave_runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def chosen(posts: list, seed: int, k: int) -> list:
    """Indices of the posteriors to check: the first of most waves, and
    k - 1 others drawn from the seed."""
    if not posts:
        return []
    longest = max(range(len(posts)), key=lambda i: posts[i]["runs"])
    rest = [i for i in range(len(posts)) if i != longest]
    rng = np.random.default_rng(run_seed(seed, 0, CHECK_STREAM))
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[int(j)] for j in picks)


def check(cell: Cell, seed: int, result: dict, device) -> dict:
    """The compared numbers of a run, each {"value", "limit"}: the gap of
    the run's tolerance to the float32 reference's pilot, and over the
    checked posteriors (each {"seed", "theta", "dist", "runs"}) the
    accepted rows that differ and the waves that differ. The program's run
    and the control (`control.py`) are both judged here."""
    from perfbench import reference as ref

    c = ref.Model(cell.config).on(device).with_observed(cell.observed)
    w, target = cell.workload, int(cell.config["target_accepted"])
    tol_ref = ref.pilot_tolerance(c, int(w["pilot_seed"]), float(w["quantile"]),
                                  cell.n_pilot, cell.batch)
    tol = result["tolerance"]
    rows = waves = 0
    for i in chosen(result["posteriors"], seed, int(w["check_posteriors"])):
        p = result["posteriors"][i]
        theta, dist, runs = ref.posterior(c, p["seed"], tol, cell.batch, target,
                                          cell.max_waves)
        rows += ref.mismatched_rows(p["theta"], p["dist"], theta, dist)
        waves += abs(runs - p["runs"])
    values = {"tolerance_gap": abs(tol - tol_ref) / abs(tol_ref), "mismatched_rows": rows,
              "waves_gap": waves}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    posteriors: list
    window_s: float
    setup_s: float
    counters: dict  # the program's counters over the window
    trace: dict | None  # the window's trace summary

    @property
    def days(self) -> int:
        return int(self.cell.config["days"])

    def ops(self, samples: float) -> float:
        """The configuration's operations of `samples` whole samples."""
        c = self.cell.config
        return samples * (self.days * float(c["ops_per_sample_day"]) + float(c["ops_per_sample"]))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device_type: str = "cuda", root: Path = ROOT) -> dict:
    """One run: the result object, without the JAX check of `main`."""
    import torch

    from perfbench import trace as tr

    manifest, entry, workload, config = cell_files(name, root)
    cell = make_cell(name, entry, workload, config)
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    out = window(cell, seed, seconds, trace, device)
    setup_s = out["window_start"] - t_start
    run = Run(cell, out["posteriors"], out["window_s"], setup_s, out["counters"],
              out["trace"])
    metrics = {}
    for metric, unit in cell_metrics(manifest, name, trace):
        value = reader(metric)(run)
        if value is not None:
            metrics[metric] = {"value": value, "unit": unit}
    checks = check(cell, seed, out, device)
    target = int(config["target_accepted"])
    failed = sum(p["accepted"] < target for p in out["posteriors"])
    correct = failed == 0 and bool(out["posteriors"]) and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device_type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device_type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    per_second = np.bincount([int(p["end_s"]) for p in out["posteriors"]]).tolist()
    result = {"correct": correct, "attempted": len(out["posteriors"]), "failed": failed,
              "metrics": metrics, "device": dev, "per_second": per_second}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": tr.top(run.trace["device_s"]),
                               "idle_gaps": tr.top(run.trace["idle_s"])}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of the benchmark of repro_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()

    import torch

    torch.set_num_threads(2)
    _, entry, _, _ = cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load none of {FORBIDDEN}",
              file=sys.stderr)
        return 4
    print(f"window: posteriors ended in each second {result.pop('per_second')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
