"""Where the tile route's time goes on Li et al. 2020's wave (20,000 x 14 x
375, `perfbench/configs/li2020_china.json`), on one CUDA card.

    python3 experiments/li2020_tile_phases.py [--launches 10]

Builds copies of `csrc/abc_sim_regional_li2020.cu` into `build/experiments/`,
each with one step of the tile kernel's day cut out of its header (for
timing only: their distances are wrong): `no_rows` (step 1, the coupled
rows), `no_pass` (step 2, the region pass) and `no_chain` (step 3, the
serial chain), beside the shipped text. Times each copy's wave entry by
CUDA events in turns (shipped, cut, cut, shipped), twice: with the blocks
the occupancy query finds resident on each SM (one for Li et al. at 375
cities, where the two layouts are the same launch) and alone (the
residency taken as 1, so the grid is one block an SM). Prints one JSON
line with the times, what ptxas reported, each copy's blocks an SM, the
region pass's SASS census a city-day (`sass.tile_region_census`,
`cuobjdump -sass` of the shipped copy) and its issue floor, and the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "experiments")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from abc_sim_common import build_copies  # noqa: E402

#: (copy, the header's text to cut, what replaces it)
CUTS = {
    "no_rows": ("          switch (rpad / TILE_RBLOCK) {", "          if (false) switch (rpad / TILE_RBLOCK) {"),
    "no_pass": ("        // 2. the region pass\n        if (valid) {",
                "        // 2. the region pass\n        if (false) {"),
    "no_chain": ("        if (threadIdx.x < TS && valid) {\n          if (pool) {",
                 "        if (false) {\n          if (pool) {"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--launches", type=int, default=10)
    p.add_argument("--batch", type=int, default=20_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("li2020_tile_phases: needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench import harness
    from perfbench import reference as pref
    from repro_torch.kernels import abc_sim, build, ops, sass

    csrc = build.CSRC
    header = (csrc / "abc_sim_regional_tile.cuh").read_text()
    unit = (csrc / "abc_sim_regional_li2020.cu").read_text()
    jobs = []
    for tag in ("shipped", *CUTS):
        text = header
        if tag in CUTS:
            old, new = CUTS[tag]
            assert text.count(old) == 1, tag
            text = text.replace(old, new)
        out = Path(ROOT / "build" / "experiments")
        out.mkdir(parents=True, exist_ok=True)
        (out / f"tile_{tag}.cuh").write_text(text)
        jobs.append((f"li2020_{tag}", unit.replace('"abc_sim_regional_tile.cuh"',
                                                   f'"tile_{tag}.cuh"'),
                     build.flags("abc_sim_regional_li2020"), [csrc]))
    libs = build_copies(jobs)
    config = json.loads((ROOT / "perfbench" / "configs" / "li2020_china.json").read_text())
    spec = harness.program_spec(config)
    dev = torch.device("cuda", 0)
    obs = torch.as_tensor(pref.observed_series(pref.Model(config), config["theta"],
                                               config["data_seed"]), device=dev)
    sim = ops.make_abc_sim(obs, population=config["population"], a0=config["a0"],
                           r0=config["r0"], d0=config["d0"], model=spec)
    prior = spec.prior()
    theta = torch.empty((args.batch, spec.n_params), device=dev)
    dist = torch.empty((args.batch,), device=dev)
    shipped_lib = abc_sim._lib

    def wave_of(lib):
        """The wave's `abc_sim.Launch` with `lib`, a copy's library, in the
        shipped one's place (its occupancy query made now)."""
        abc_sim._lib = lambda name: lib
        try:
            return abc_sim.launch(spec, "wave", args.batch, obs=sim.obs_summary,
                                  fconst=sim.fconst, iconst=sim.iconst, weights=sim.weights,
                                  mobility=sim.mob, tile=sim.tile, pool=sim.pool)
        finally:
            abc_sim._lib = shipped_lib

    def time_ms(lib) -> float:
        wave = wave_of(lib)

        def launch(i):
            wave(200 + i, 100 + i, prior.lows, prior.highs, out=(theta, dist))

        launch(0)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(args.launches):
            launch(i)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.launches

    for lib, _, _ in libs.values():
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    shipped = libs["li2020_shipped"][0]
    v = abc_sim.variant(sim.iconst[1:abc_sim.I_N_WINDOWS], True)
    result = {"batch": args.batch, "launches": args.launches, "variant": v, "ms": {},
              "ptxas": {}, "resident": {}}
    queried = abc_sim._tile_resident
    for layout, resident in (("in_flight", None), ("alone", 1)):
        abc_sim._tile_resident = queried if resident is None else (lambda *a, n=resident: n)
        try:
            result["ms"][layout] = {}
            for tag in CUTS:
                cut = libs[f"li2020_{tag}"][0]
                t = [time_ms(shipped), time_ms(cut), time_ms(cut), time_ms(shipped)]
                result["ms"][layout][tag] = {
                    "shipped": [t[0], t[3]], "cut": [t[1], t[2]],
                    "step_ms": float(np.mean([t[0], t[3]]) - np.mean(t[1:3]))}
        finally:
            abc_sim._tile_resident = queried
    symbol = abc_sim.variant_symbol(spec, v, "tile")
    for tag, (lib, _, kernels) in libs.items():
        result["ptxas"][tag] = next((k for n, k in kernels.items() if symbol in n), None)
        result["resident"][tag] = abc_sim._tile_resident(lib, spec.kernel, spec.n_regions, v,
                                                         dev)
    text = libs["li2020_shipped"][1]
    if text is not None:
        body = next(b for n, b in sass.parse_functions(text).items() if symbol in n)
        census = sass.tile_region_census(body)
        props = torch.cuda.get_device_properties(dev)
        clock = float(os.popen("nvidia-smi --query-gpu=clocks.max.sm --format=csv,noheader,"
                               "nounits").read().split()[0])
        result["region_pass_sass"] = census
        result["region_pass_floor"] = sass.tile_region_floor_ms(
            census, spec.n_regions, args.batch, int(config["days"]),
            props.multi_processor_count, clock)
    result["card"] = os.popen("nvidia-smi --query-gpu=name,power.limit "
                              "--format=csv,noheader").read().strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
