#!/usr/bin/env python3
"""Both routes of abc_sim's region axis on one card: the thread-per-sample
kernel (`csrc/abc_sim_regional.cuh`) and the warp-per-sample one
(`csrc/abc_sim_regional_warp.cuh`).

    python3 experiments/abc_sim_regional_routes.py [--quick]

It builds the port's kernels and reports the warp kernel's registers, stack
and spills for every struct and variant, and the warp census
(`sass.regional_warp_census`) of metapop_seir's wave entry on the identity
summary, pooled and not; it writes the warp kernels' `cuobjdump -sass` to
`build/experiments/regional_warp_sass/`. It holds both entries of both routes
bitwise against the plain version: metapop_seir on a ring at 0.1 at R = 4,
10, 32, 33, 64, 100 and 128 (100 pooled as well), and seiard regionalized
to R = 40 (1024 x 49 each). Unless `--quick`, it then places the crossover
of the two routes: it times the wave entry of both routes in turns (thread,
warp, warp, thread) at the cells `CELLS` names, which chip_smoke.py's timing
phase does not time (it times R = 4, 10, 32 and 100 at 20,000 x 49 and R =
4 and 100 at 100,000), beside the operation bound and each route's issue
floor, and the warp route at blocks of 128, 256, 384 and 512 threads in
turns (forward, then back) at R = 100. It prints one JSON line (also
written to `build/experiments/abc_sim_regional_routes.json`), then the
card's nvidia-smi name and power limit.

`experiments/abc_sim_parent.py` holds the kernels this route leaves alone
(the flat ones, and the thread route at R=4) against an older checkout.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

BLOCKS = (128, 256, 384, 512)
#: (R, batch) around the crossover (`abc_sim.WARP_MIN_REGIONS`), at the
#: timing cell's batch, half the CLI's, the CLI's and ten times the CLI's
CELLS = tuple((R, 20_000) for R in (8, 12, 16, 24, 64)) \
    + tuple((R, 50_000) for R in (10, 12, 14, 16, 18, 20, 24)) \
    + tuple((R, 100_000) for R in (8, 10, 12, 16, 20, 22, 24, 32, 48)) \
    + tuple((R, 1_000_000) for R in (12, 16, 20, 22, 24, 32, 48))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("abc_sim_regional_routes: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize
    from repro_torch.kernels import abc_sim, build, ops, ref, sass

    quick = "--quick" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = cs.nvidia_smi_line()
    out = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    metapop = get_model("metapop_seir")

    # ---- build: the warp kernels' ptxas report, their SASS, the census
    info = build.build_all()
    ptxas = {}
    for name, lib in info.items():
        if name.startswith("abc_sim_regional_"):
            ptxas[name] = {k: v for k, v in lib.kernels.items() if "regional_warp_kernel" in k}
    out["warp_ptxas"] = {name: {"kernels": len(k),
                                "registers": sorted({v["registers"] for v in k.values()}),
                                "stack_bytes": sorted({v["stack_bytes"] for v in k.values()}),
                                "spill_bytes": sorted({v["spill_stores"] + v["spill_loads"]
                                                       for v in k.values()})}
                         for name, k in ptxas.items()}
    out["nvcc_s"] = {k: v.seconds for k, v in info.items()}
    sass_dir = os.path.join(ROOT, "build", "experiments", "regional_warp_sass")
    os.makedirs(sass_dir, exist_ok=True)
    flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    census = {}
    for lib_name in ("abc_sim_regional_metapop_seir", "abc_sim_regional_siard"):
        text = build.sass_text(lib_name)
        if text is None:
            census = "not measured: the toolkit has no cuobjdump"
            break
        funcs = sass.parse_functions(text)
        with open(os.path.join(sass_dir, f"{lib_name}.txt"), "w") as f:
            for k, body in funcs.items():
                if "regional_warp_kernel" in k:
                    f.write(f"\tFunction : {k}\n" + "\n".join(
                        f"        {i} ;" for i in body) + "\n")
        spec = metapop if "metapop" in lib_name else regionalize(get_model("siard"), 40)
        symbol = abc_sim.kernel_symbol(spec, flags, True, "warp")
        names = [k for k in funcs if symbol in k]
        for pooled in (False, True):
            try:
                c = sass.regional_warp_census(funcs[names[0]], bool(spec.coupled), pooled)
            except Exception as e:  # noqa: BLE001 -- reported, the run goes on
                c = {"error": repr(e)}
            census[f"{lib_name} pooled={pooled}"] = c
    out["warp_census"] = census

    # ---- both routes of both entries against the plain version, bitwise
    def case(spec, batch, summary="identity", distance="euclidean", seed=11, prior_seed=7):
        ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        ob = torch.as_tensor(ds.observed, device=dev)
        sim = ops.make_abc_sim(ob, model=spec, summary=summary, distance=distance, **kw)
        prior = spec.prior()
        th = prior.sample(prior_seed, batch, dev)
        want = ref.abc_sim_distance_ref(th, seed, ob, model=spec, summary=summary,
                                        distance=distance, **kw)
        want_w = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
        got = []
        for route in abc_sim.ROUTES:
            tag = f"{spec.name} {summary} {batch}x49 {route}"
            d = sim.launch("distance", batch, route)(seed, abc_sim.theta_to_soa(th))
            th_w, d_w = sim.launch("wave", batch, route)(seed, prior_seed, prior.lows,
                                                         prior.highs)
            if not torch.equal(th_w, th):
                raise AssertionError(f"{tag}: the wave entry's theta differs from prior.sample")
            got.append(cs.bitwise(f"{tag} theta-in entry vs plain", d, want))
            got.append(cs.bitwise(f"{tag} wave entry vs plain", d_w, want_w))
        return got

    comparisons = []
    for R in (4, 10, 32, 33, 64, 100, 128):
        spec = metapop if R == 4 else regionalize(metapop, R, "ring:0.1")
        comparisons += case(spec, 1024)
    comparisons += case(regionalize(metapop, 100, "ring:0.1"), 1024, "region_pooled")
    comparisons += case(regionalize(get_model("seiard"), 40), 1024)
    out["comparisons"] = len(comparisons)
    out["all_bitwise"] = all(c["bitwise_equal"] for c in comparisons)
    if not quick:
        out["timing"] = timing(dev, cs, census if isinstance(census, dict) else {})
    line = json.dumps(out)
    with open(os.path.join(ROOT, "build", "experiments", "abc_sim_regional_routes.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    print(smi, flush=True)
    return 0


def timing(dev, cs, census) -> dict:
    """Both routes' wave entries in turns at each cell, and the warp route's
    blocks in turns at R = 100."""
    import torch

    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize
    from repro_torch.kernels import abc_sim, build, ops, sass

    metapop = get_model("metapop_seir")
    flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    thread_census = cs.regional_census(build, metapop, flags)
    warp_census = census.get("abc_sim_regional_metapop_seir pooled=False")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cells, blocks = [], {}
    with cs.SmClock() as clock:
        sims = {}
        for R in sorted({R for R, _ in CELLS} | {100}):
            spec = metapop if R == 4 else regionalize(metapop, R, "ring:0.1")
            ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
            kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
            ob = torch.as_tensor(ds.observed, device=dev)
            sims[R] = (spec, ops.make_abc_sim(ob, model=spec, **kw),
                       lower_summary(get_summary(None), "euclidean", ob, n_regions=R))

        launches = {}

        def run(R, batch, route, block=None):
            spec, sim, _ = sims[R]
            key = (R, batch, route, block)
            if key not in launches:
                launches[key] = abc_sim.launch(
                    spec, "wave", batch, obs=sim.obs_summary, fconst=sim.fconst,
                    iconst=sim.iconst, weights=sim.weights, mobility=sim.mob, pool=sim.pool,
                    block=block, route=route)
            box = spec.prior()
            return launches[key](99, 12, box.lows, box.highs)

        clock.start_counting(lambda: run(100, 20_000, "warp"))
        for R, batch in CELLS:
            spec, sim, low = sims[R]
            ms = {"thread": [], "warp": []}
            for route in ("thread", "warp", "warp", "thread"):
                once = cs.cuda_ms(lambda: run(R, batch, route), 1, warmup=1)
                iters = max(1, min(50, int(300 / max(once, 1e-3))))
                ms[route].append(cs.cuda_ms(lambda: run(R, batch, route), iters, warmup=0))
            mhz = clock.median()
            w_ops = abc_sim.wave_ops(spec, low, batch)
            n_bytes = abc_sim.bytes_moved(spec, batch, 49)
            ops_ms = w_ops / cs.F32_OPS_PER_S * 1e3
            bytes_ms = n_bytes / cs.HBM_BYTES_PER_S * 1e3
            n_chan = spec.total_observed
            floors = {
                "thread": (sass.regional_issue_floor_ms(thread_census, R, R, batch, 49, n_sm, mhz)
                           if thread_census and mhz else None),
                "warp": (sass.regional_warp_issue_floor_ms(warp_census, R, n_chan, batch, 49,
                                                           n_sm, mhz)
                         if warp_census and warp_census.get("shape_ok") and mhz else None)}
            cells.append({
                "regions": R, "batch": batch, "days": 49, "turns_ms": ms,
                "ms": {r: float(np.mean(v)) for r, v in ms.items()},
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "issue_floor_ms": {r: f["floor_ms"] if f else None for r, f in floors.items()},
                "issue_floor": floors,
                "route_chosen": abc_sim.regional_route(spec, batch)})
        for batch in (20_000, 100_000):
            turns = {b: [] for b in BLOCKS}
            for b in BLOCKS + BLOCKS[::-1]:
                turns[b].append(cs.cuda_ms(lambda: run(100, batch, "warp", b), 5, warmup=1))
            blocks[str(batch)] = {str(b): float(np.mean(v)) for b, v in turns.items()}
        clock_summary = clock.summary()
    return {"cells": cells, "warp_blocks_r100_ms": blocks, "sm_clock_mhz": clock_summary,
            "sms": n_sm, "warp_default_block": abc_sim.WARP_DEFAULT_BLOCK,
            "warp_min_regions": [list(p) for p in abc_sim.WARP_MIN_REGIONS]}


if __name__ == "__main__":
    sys.exit(main())
