"""Time the plain reference at a regional configuration's scale, so that the
check of a cell of that scale can be sized: `distances` of the toy transport
model of `test_perfbench_transport.py` (traveller counts over N - D, an
outbound total a region, a population a region) at R regions, D days and N
samples, once whole and once in the pieces that `posterior` enqueues.

    python3 perfbench/reference_timing.py --regions 375 --days 14 --samples 100000

prints one JSON line a timing; the traveller matrix and the populations are
made from `--seed`. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import reference as ref  # noqa: E402
from perfbench import test_perfbench_transport as toy  # noqa: E402


def toy_config(regions: int, days: int, seed: int, files: Path) -> dict:
    """The toy at `regions`, its travellers (a few thousand a day out of
    each region) and populations (1e5 to 1e7) written under `files`."""
    rng = np.random.default_rng(seed)
    mob = rng.random((regions, regions)) * (1 - np.eye(regions)) * 20.0
    np.save(files / "travellers.npy", mob.astype(np.float32))
    np.save(files / "populations.npy", (10 ** rng.uniform(5, 7, regions)).astype(np.float32))
    return dict(toy.TOY, regions=regions, days=days, seed_region=0)


def timed(fn, device) -> tuple:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--regions", type=int, default=375)
    p.add_argument("--days", type=int, default=14)
    p.add_argument("--samples", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    sys.modules["perfbench.models.toy_transport"] = toy.toy_module()
    with tempfile.TemporaryDirectory() as files:
        ref.CONFIGS = Path(files)
        cfg = toy_config(args.regions, args.days, args.seed, ref.CONFIGS)
        model = ref.Model(cfg)
        obs = ref.observed_series(model, cfg["theta"], cfg["data_seed"])
        c = model.on(device).with_observed(obs)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    idx = torch.arange(args.samples, device=device)
    theta = ref.prior_draw(c, 1234, idx)
    pieces = -(-args.samples // ref._rows_per_piece(model))
    timed(lambda: ref.distances(c, theta[:256], 5678, idx[:256]), device)  # warm-up
    for repeat in range(args.repeats):
        _, whole = timed(lambda: ref.distances(c, theta, 5678, idx), device)
        out, piecewise = timed(lambda: [d.float().cpu() for _, d, _ in ref._enqueue(
            c, args.seed, (ref.PRIOR_STREAM, ref.SIM_STREAM), 0, 1, args.samples)], device)
        finite = float(torch.isfinite(torch.cat(out)).float().mean())
        print(json.dumps({
            "regions": args.regions, "days": args.days, "samples": args.samples,
            "repeat": repeat, "distances_s": whole, "enqueued_s": piecewise, "pieces": pieces,
            "finite_share": finite, "device": kind,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
