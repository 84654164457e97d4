"""The control of a cell's comparison: the reference put in the program's
place and computed in bfloat16, the precision below the float32 that the
configurations state, then held to the float32 reference by the same
comparison as the program (`harness.check`). It has to come out as
not correct; the numbers it gives are the upper readings of `PERF.md`.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13 [--posteriors 3]

prints one JSON line a seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402
from perfbench import reference as ref  # noqa: E402


def readings(cell: harness.Cell, seed: int, posteriors: int, device,
             dtype=torch.bfloat16) -> dict:
    """The compared numbers of the control at `dtype` for `posteriors`
    posteriors of the window's seeds under `seed`, each beside its limit:
    its tolerance and posteriors, as a run's result, judged by
    `harness.check`."""
    lower = ref.Model(cell.config).on(device, dtype).with_observed(cell.observed)
    w, target = cell.workload, int(cell.config["target_accepted"])
    tol = ref.pilot_tolerance(lower, int(w["pilot_seed"]), float(w["quantile"]), cell.n_pilot,
                              cell.batch)
    posts = []
    for i in range(posteriors):
        s = harness.run_seed(seed, i, harness.WINDOW_STREAM)
        theta, dist, runs = ref.posterior(lower, s, tol, cell.batch, target, cell.max_waves)
        posts.append({"seed": s, "theta": theta, "dist": dist, "runs": runs})
    return harness.check(cell, seed, {"tolerance": tol, "posteriors": posts}, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--posteriors", type=int, default=None,
                   help="posteriors a seed (default: the cell's check_posteriors)")
    args = p.parse_args(argv)
    _, entry, workload, config = harness.cell_files(args.workload)
    cell = harness.make_cell(args.workload, entry, workload, config)
    device = torch.device("cuda", 0)
    posteriors = args.posteriors or int(workload["check_posteriors"])
    for seed in args.seeds:
        checks = readings(cell, seed, posteriors, device)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": "bfloat16",
                          "correct": correct, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
