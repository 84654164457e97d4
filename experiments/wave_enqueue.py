"""The host time of one wave's enqueue in a perfbench cell's closed loop
(`wave_enqueue_us`: the mean `abc.wave` span of the program's recorder,
`repro_torch.runtime.trace`), on one CUDA card, without the profiler.

    python3 experiments/wave_enqueue.py --workload siard_italy.b1m \
        [--root build/parent] [--seconds 5] [--seed 7]

Makes the cell's program as `perfbench/harness.py` does, from the tree at
`--root` (this checkout by default, or an unpacked other commit, so that
two commits run the same script), runs the cell's warm-up posteriors, then
posteriors back to back for `--seconds` with the recorder on. Prints one
JSON line: the count, mean and median of the `abc.wave` and `abc.segment`
spans in microseconds, the posteriors and waves, and the card's nvidia-smi
name and power limit.
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
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("wave_enqueue: needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench import harness
    from repro_torch.core import abc
    from repro_torch.kernels import build
    from repro_torch.runtime import trace

    dev = torch.device("cuda", 0)
    build.build_all()
    _, entry, workload, config = harness.cell_files(args.workload)
    cell = harness.make_cell(args.workload, entry, workload, config)
    ds, cfg, runner, _ = harness.make_program(cell, dev)
    for i in range(int(cell.workload["warmup_posteriors"])):
        abc.run_abc(ds, cfg, seed=harness.run_seed(args.seed, i, harness.WARMUP_STREAM),
                    wave_runner=runner)
    torch.cuda.synchronize(dev)
    trace.clear()
    trace.enable()
    n, waves, t0 = 0, 0, time.perf_counter()
    while time.perf_counter() < t0 + args.seconds:
        post = abc.run_abc(ds, cfg, seed=harness.run_seed(args.seed, n, harness.WINDOW_STREAM),
                           wave_runner=runner)
        n, waves = n + 1, waves + int(post.runs)
    trace.disable()
    records = trace.records()

    def spans(name: str) -> dict:
        us = [(r[2] - r[1]) / 1e3 for r in records if r[0] == name]
        return {"n": len(us), "mean_us": statistics.fmean(us) if us else None,
                "median_us": statistics.median(us) if us else None}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"workload": args.workload, "root": str(root), "seed": args.seed,
                      "seconds": args.seconds, "posteriors": n, "waves_run": waves,
                      "abc.wave": spans("abc.wave"), "abc.segment": spans("abc.segment"),
                      "card": smi.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
