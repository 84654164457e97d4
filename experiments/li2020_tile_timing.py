"""Time the tile route of the region axis (`csrc/abc_sim_regional_tile.cuh`)
on Li et al. 2020's 375 cities, at the benchmark cell's wave: 20,000 samples
x 14 days (`perfbench/configs/li2020_china.json`).

    python3 experiments/li2020_tile_timing.py [--batch 20000] [--launches 20]

Prints, and writes to `build/experiments/li2020_tile_timing.json`: the card and
its power limit; what ptxas reported for the tile kernels (registers,
shared memory, spills); a check of one wave against the plain version on
the card (bitwise, `--check` samples); the wave entry's time by CUDA events
over `--launches` launches after a warm-up, in two turns; the plain
version's time for one wave; and the bound of the frozen count at 67
TFLOP/s. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=20_000)
    p.add_argument("--launches", type=int, default=20)
    p.add_argument("--check", type=int, default=2_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("li2020_tile_timing: needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench import harness
    from perfbench import reference as pref
    from perfbench.peaks import F32_OPS_PER_S
    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda", 0)
    t0 = time.time()
    infos = build.build_all()
    out = {"card": card(), "build_s": time.time() - t0,
           "ptxas": {name: {k: v for k, v in info.kernels.items() if "tile" in k}
                     for name, info in infos.items() if name.startswith("abc_sim_regional_")}}
    config = json.loads((ROOT / "perfbench" / "configs" / "li2020_china.json").read_text())
    spec = harness.program_spec(config)
    obs_np = pref.observed_series(pref.Model(config), config["theta"], config["data_seed"])
    obs = torch.as_tensor(obs_np, device=dev)
    kw = dict(population=config["population"], a0=config["a0"], r0=config["r0"],
              d0=config["d0"], model=spec)
    sim = ops.make_abc_sim(obs, **kw)
    prior = spec.prior()
    out["entry"] = sim.entry("wave", args.batch)

    # one wave against the plain version on the card
    theta, dist = sim.wave(prior, 21, 22, args.check)
    want = ref.abc_sim_distance_ref(theta, 22, obs, **kw)
    want = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
    th_want = prior.sample(21, args.check, dev)
    out["check"] = {"samples": args.check,
                    "theta_bitwise": bool(torch.equal(theta.view(torch.int32),
                                                      th_want.view(torch.int32))),
                    "dist_bitwise": bool(torch.equal(dist.view(torch.int32),
                                                     want.view(torch.int32))),
                    "dist_quantiles": np.quantile(dist.cpu().numpy(), [0.001, 0.5]).tolist()}

    # the wave entry at the cell's batch, CUDA events, two turns
    buf = (torch.empty((args.batch, spec.n_params), device=dev),
           torch.empty((args.batch,), device=dev))
    for _ in range(2):
        sim.wave(prior, 1, 2, args.batch, out=buf)
    torch.cuda.synchronize()
    turns = []
    for turn in range(2):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(args.launches):
            sim.wave(prior, 100 + i, 200 + i, args.batch, out=buf)
        stop.record()
        stop.synchronize()
        turns.append(start.elapsed_time(stop) / args.launches)
    out["wave_ms"] = turns
    ops_wave = args.batch * (config["days"] * config["ops_per_sample_day"]
                             + config["ops_per_sample"])
    out["bound_ms"] = 1e3 * ops_wave / F32_OPS_PER_S
    out["roofline_pct"] = [100.0 * out["bound_ms"] / t for t in turns]

    # the plain version's wave, one call
    theta = prior.sample(3, args.batch, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref.abc_sim_distance_ref(theta, 4, obs, **kw)
    torch.cuda.synchronize()
    out["plain_ms"] = 1e3 * (time.perf_counter() - t)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    text = json.dumps(out, indent=1)
    print(text)
    out_dir = ROOT / "build" / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "li2020_tile_timing.json").write_text(text)
    ok = out["check"]["theta_bitwise"] and out["check"]["dist_bitwise"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
