"""Run perfbench cells on the card, one run a seed, the sides in turns, and
summarise each end-to-end metric by its median and its quartile spread.

    python3 experiments/bench_turns.py --workload li2020_china.b20k \
        --seeds 2147483659,2718281829,3141592653 --traced 4011111111 \
        [--parent build/parent] [--seconds 10] [--out chiprun_out/bench]

Each run is `python3 perfbench/run.py --workload W --seed S --seconds T
--trace 0|1` from the root of its side: this checkout ("change") and, with
`--parent`, an unpacked parent commit. With both sides the seeds run in
turns, parent then change, then change then parent on the next seed. The
`--traced` seeds run once a side with `--trace 1`. Each run's last line
goes to `<out>/<side>-<seed>[-traced].json`, its standard error beside it,
and one summary line a run to standard output; then, a side and a metric
each, the median and the spread (the first to the third quartile of
`statistics.quantiles(values, n=4)` over the median) of the untraced runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(side: str, root: Path, workload: str, seed: int, seconds: float, trace: bool,
        out: Path) -> dict:
    tag = f"{side}-{seed}{'-traced' if trace else ''}"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                        str(seed), "--seconds", str(seconds), "--trace", str(int(trace))],
                       cwd=root, capture_output=True, text=True)
    (out / f"{tag}.err").write_text(p.stderr)
    lines = p.stdout.strip().splitlines()
    (out / f"{tag}.json").write_text(lines[-1] if lines else "")
    try:
        r = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        r = {}
    line = {"run": tag, "rc": p.returncode, "wall_s": round(time.perf_counter() - t0, 1),
            "correct": r.get("correct"), "attempted": r.get("attempted"),
            "failed": r.get("failed"),
            "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
            "checks": {k: v["value"] for k, v in r.get("checks", {}).items()},
            "device": r.get("device")}
    print(json.dumps(line), flush=True)
    return line


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma list of untraced seeds")
    p.add_argument("--traced", default="", help="comma list of traced seeds")
    p.add_argument("--parent", default=None, help="root of an unpacked parent commit")
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--out", default="chiprun_out/bench")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sides = [("change", ROOT)]
    if args.parent:
        sides = [("parent", Path(args.parent).resolve()), ("change", ROOT)]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    runs = {side: [] for side, _ in sides}
    for i, seed in enumerate(seeds):
        for side, root in (sides if i % 2 == 0 else sides[::-1]):
            runs[side].append(run(side, root, args.workload, seed, args.seconds, False, out))
    for seed in (int(s) for s in args.traced.split(",") if s):
        for side, root in sides:
            run(side, root, args.workload, seed, args.seconds, True, out)
    for side, lines in runs.items():
        ok = [r for r in lines if r["rc"] == 0 and r["metrics"]]
        names = sorted({k for r in ok for k in r["metrics"]})
        summary = {k: {"median": statistics.median(r["metrics"][k] for r in ok),
                       "spread": spread([r["metrics"][k] for r in ok]) if len(ok) > 1 else None}
                   for k in names}
        print(json.dumps({"side": side, "workload": args.workload, "runs": len(lines),
                          "correct": sum(bool(r["correct"]) for r in lines),
                          "summary": summary}), flush=True)
    return 0 if all(r["rc"] == 0 and r["correct"] for v in runs.values() for r in v) else 1


if __name__ == "__main__":
    raise SystemExit(main())
