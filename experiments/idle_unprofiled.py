"""The card's idle share in a perfbench cell's closed loop with the profiler
off, on one CUDA card.

    python3 experiments/idle_unprofiled.py --workload siard_italy.b1m \
        [--root build/parent] [--posteriors 300] [--seed 7]

`device_idle_share` is read from a traced run, under `torch.profiler`,
whose CUPTI tracing adds host time to every launch and to every replay of
a CUDA graph, so it can read more idle than the untraced runs have. Here
the same `--posteriors` posteriors of the cell (its program made as
`perfbench/harness.py` makes it, from the tree at `--root`, after its
warm-up posteriors) run four times in one process, the profiler off, on,
off, on: the device's busy time a posterior comes from the profiled passes
(the union of kernel, copy and fill intervals, `perfbench/trace.py`), the
wall time a posterior from both kinds, so that

    idle_share_unprofiled = 1 - busy / wall with the profiler off
    idle_share_profiled   = 1 - busy / wall with the profiler on

Prints one JSON line with each pass's ms a posterior, the busy ms, the
waves a posterior, both shares and the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--posteriors", type=int, default=300)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("idle_unprofiled: needs a CUDA card", file=sys.stderr)
        return 3
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness
    from perfbench import trace as tr
    from repro_torch.core import abc
    from repro_torch.kernels import build

    torch.set_num_threads(2)  # as perfbench/harness.py runs
    dev = torch.device("cuda", 0)
    build.build_all()
    _, entry, workload, config = harness.cell_files(args.workload)
    cell = harness.make_cell(args.workload, entry, workload, config)
    ds, cfg, runner, _ = harness.make_program(cell, dev)
    for i in range(int(cell.workload["warmup_posteriors"])):
        abc.run_abc(ds, cfg, seed=harness.run_seed(args.seed, i, harness.WARMUP_STREAM),
                    wave_runner=runner)
    ms = {"off": [], "on": []}
    busy, waves = [], 0
    for mode in ("off", "on", "off", "on"):
        prof = profile(activities=[ProfilerActivity.CUDA]) if mode == "on" else None
        torch.cuda.synchronize(dev)
        if prof is not None:
            prof.start()
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        waves = 0
        for k in range(args.posteriors):
            post = abc.run_abc(ds, cfg, seed=harness.run_seed(args.seed, k, harness.WINDOW_STREAM),
                               wave_runner=runner)
            waves += int(post.runs)
        torch.cuda.synchronize(dev)
        t1, t1_ns = time.perf_counter(), time.time_ns()
        ms[mode].append((t1 - t0) * 1e3 / args.posteriors)
        if prof is not None:
            prof.stop()
            summary = tr.summarize(tr.device_intervals(prof, t0_ns, t1_ns), t0_ns, t1_ns,
                                   tr.Spans())
            busy.append(summary["busy_s"] * 1e3 / args.posteriors)
            del prof
    busy_ms = statistics.fmean(busy)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"workload": args.workload, "root": str(root), "seed": args.seed,
                      "posteriors": args.posteriors, "waves_per_posterior": waves / args.posteriors,
                      "ms_off": ms["off"], "ms_on": ms["on"], "busy_ms": busy,
                      "idle_share_unprofiled": 1 - busy_ms / statistics.fmean(ms["off"]),
                      "idle_share_profiled": 1 - busy_ms / statistics.fmean(ms["on"]),
                      "card": smi.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
