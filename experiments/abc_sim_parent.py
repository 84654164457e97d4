#!/usr/bin/env python3
"""This tree's `abc_sim` kernel against another checkout's, on one CUDA card.

    git archive <commit> | tar -x -C build/parent    # any directory .gitignore lists
    python3 experiments/abc_sim_parent.py build/parent

Builds the other checkout's SIARD source (`csrc/abc_sim_siard.cu`, or
`csrc/abc_sim.cu` in a checkout from before each model had its own) with
this tree's nvcc flags for it, which keep `--fmad=false`, into
`build/experiments/`, then at 100,000 and 1,000,000 x 49 days on Italy:

* checks that its theta-in entry (`abc_sim_distance_siard`, the same C
  interface in both trees) gives the same distances, bit for bit, as this
  tree's theta-in and wave entries;
* times them in turns: other, this tree's theta-in, wave, wave, theta-in,
  other, each at its own tree's `DEFAULT_BLOCK`;
* counts the instructions a sample-day of both kernels' theta-in and wave
  variants at the identity summary, each by this tree's `kernels/sass.py`
  and by the other checkout's own, so that a change to the census rule
  shows apart from a change to the kernel; and gives each kernel's issue
  floor at the SM clock read under load (by this tree's rule).

Then, for sir, seir and seiard, for metapop_seir's region axis at R=4 on
its thread route (`csrc/abc_sim_regional.cuh`) and at R=100 on its warp
route (`csrc/abc_sim_regional_warp.cuh`), each where the other checkout
has it: builds it the same way, compares the SASS of each kernel with this
tree's, function by function (the main path's regional variants go to
`build/experiments/parent_sass/`), checks that both wave entries give the
same theta and distances bit for bit at 100,000 x 49 (`synthetic_small` for
the models that observe no country series), and times them in turns
(other, this tree, this tree, other).

The other checkout's entries are called with its own arguments: those from
before the device gate take no trailing gate (`abc_sim_common.gated`).

Prints one JSON line, then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

import numpy as np

from abc_sim_common import argtypes, build_copies, call_distance, call_wave, entry, gated, \
    italy_inputs, stream, takes_offset, turns


def main(argv) -> int:
    import torch

    from chip_smoke import SmClock, nvidia_smi_line
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim, build, sass

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    other_csrc = os.path.join(argv[0], "src", "repro_torch", "kernels", "csrc")
    dev = torch.device("cuda", 0)
    siard = get_model("siard")
    siard_cu = next(p for p in (os.path.join(other_csrc, f) for f in (
        "abc_sim_siard.cu", "abc_sim.cu")) if os.path.isfile(p))
    lib, other_sass, ptxas = build_copies(
        [("abc_sim_other", open(siard_cu).read(), build.flags("abc_sim_siard"),
          [other_csrc])])["abc_sim_other"]
    other_gated = gated(other_csrc)  # its entries take the trailing gate
    fn = entry(lib, "abc_sim_distance_siard", argtypes("distance", other_gated))
    wrapper = open(os.path.join(other_csrc, "..", "abc_sim.py")).read()
    other_block = int(re.search(r"^DEFAULT_BLOCK = (\d+)", wrapper, re.M).group(1))

    x = italy_inputs(dev, 16)
    # census[kernel][entry][rule]: each tree's kernel counted by each tree's
    # census module
    rules = {"this_tree": sass}
    other_rule = os.path.join(other_csrc, "..", "sass.py")
    if os.path.isfile(other_rule):
        spec = importlib.util.spec_from_file_location("sass_of_other", other_rule)
        rules["other"] = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rules["other"])
    census = {}
    for kernel, text in (("this_tree", build.sass_text(abc_sim.library(siard))),
                         ("other", other_sass)):
        if text is None:
            continue
        for rule_name, rule in rules.items():
            funcs = rule.parse_functions(text)
            for entry_name, wave in (("theta_in", False), ("wave", True)):
                symbol = abc_sim.kernel_symbol(siard, x["lowered"].flags, wave)
                names = [k for k in funcs if symbol in k]
                census.setdefault(kernel, {}).setdefault(entry_name, {})[rule_name] = {
                    "function": names[0], **rule.census(funcs[names[0]])}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cells = []
    with SmClock() as clock:
        for batch, iters in ((100_000, 30), (1_000_000, 10)):
            x = italy_inputs(dev, batch)
            soa = abc_sim.theta_to_soa(x["theta"])
            mine = {e: abc_sim.launch(siard, e, batch, obs=x["obs"], fconst=x["fconst"],
                                      iconst=x["iconst"]) for e in ("distance", "wave")}

            def other():
                return call_distance(fn, soa, x["obs"], x["fconst"], x["iconst"], other_block,
                                     other_gated)

            def theta_in():
                return mine["distance"](99, soa)

            def wave():
                return mine["wave"](99, 12, x["prior"].lows, x["prior"].highs)

            d_other, d_in, (th_w, d_w) = other(), theta_in(), wave()
            equal = {"theta_in": bool(torch.equal(d_other, d_in)),
                     "wave": bool(torch.equal(d_other, d_w) and torch.equal(th_w, x["theta"]))}
            if not all(equal.values()):
                raise AssertionError(f"{batch}: the two trees' kernels differ: {equal}")
            if batch == 100_000:
                clock.start_counting(wave)
            timed = turns({"other": other, "theta_in": theta_in, "wave": wave},
                          ["other", "theta_in", "wave", "wave", "theta_in", "other"], iters)
            mhz = clock.median()
            # the other tree's theta-in entry and this tree's wave entry, as timed
            floors = {k: sass.issue_floor_ms(census[k][e]["this_tree"], batch, 49, n_sm,
                                             mhz)["floor_ms"]
                      for k, e in (("other", "theta_in"), ("this_tree", "wave"))
                      if k in census and mhz}
            cells.append({"batch": batch, "days": 49, "bitwise_equal": equal, "turns": timed,
                          "issue_floor_ms": floors})
    models = other_models(dev, other_csrc)
    smi = nvidia_smi_line()
    brief = {kernel: {e: {f"rule_of_{r}": {
        "per_day": c["per_day"], "per_sample_outside_loop": c["per_sample_outside_loop"]["total"]}
        for r, c in by_rule.items()} for e, by_rule in by_entry.items()}
        for kernel, by_entry in census.items()}
    print(json.dumps({"experiment": "abc_sim_parent", "other": argv[0], "ptxas_other": ptxas,
                      "blocks": {"other": other_block, "this_tree": abc_sim.DEFAULT_BLOCK},
                      "census": brief, "sm_clock_mhz": clock.summary(), "sms": n_sm,
                      "cells": cells, "models": models, "kind": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    print(smi)
    return 0


def other_models(dev, other_csrc: str) -> dict:
    """sir, seir, seiard, metapop_seir's thread route at R=4 and, where the
    other checkout has it, its warp route at R=100, against the other
    checkout's build of the same sources (module docstring). The SASS of the
    main path's wave variant of each regional kernel, both trees', goes to
    `build/experiments/parent_sass/`."""
    import torch

    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize
    from repro_torch.kernels import abc_sim, build, ops, sass

    metapop = get_model("metapop_seir")
    cases = [(m, get_model(m), None) for m in ("sir", "seir", "seiard")]
    cases += [("metapop_seir", metapop, "thread"),
              ("metapop_seir R=100 warp", regionalize(metapop, 100, "ring:0.1"), "warp")]
    libs = {abc_sim.library(spec) for _, spec, _ in cases}
    libs = {lib for lib in libs if os.path.isfile(os.path.join(other_csrc, lib + ".cu"))}
    built = build_copies([(f"other_{lib}", open(os.path.join(other_csrc, lib + ".cu")).read(),
                           build.flags(lib), [other_csrc]) for lib in sorted(libs)])
    sass_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "build", "experiments", "parent_sass")
    os.makedirs(sass_dir, exist_ok=True)

    def kernels(text, spec, route):
        pick = ("abc_sim_kernelI" if not spec.is_regional else
                "abc_sim_regional_warp_kernelI" if route == "warp" else
                "abc_sim_regional_kernelI")
        return {re.search(r"(abc_sim_\w*kernelI.*)", k).group(1):
                [(i.pred, i.opcode, i.operands) for i in body]
                for k, body in sass.parse_functions(text).items() if pick in k}

    out = {}
    batch = 100_000
    other_gated = gated(other_csrc)
    other_offset = takes_offset(other_csrc)  # its wave entries take a sample offset
    for tag, spec, route in cases:
        lib = abc_sim.library(spec)
        if lib not in libs:
            continue
        other_lib, other_sass, _ = built[f"other_{lib}"]
        if not hasattr(other_lib, abc_sim.entry_name(spec, "wave", route)):
            continue  # a checkout from before this route
        mine = kernels(build.sass_text(lib), spec, route)
        theirs = kernels(other_sass, spec, route) if other_sass else {}
        same = sum(mine.get(k) == v for k, v in theirs.items())
        if spec.is_regional and other_sass:
            symbol = abc_sim.variant_symbol(spec, 8, route)
            for tree, funcs in (("this_tree", mine), ("other", theirs)):
                name = next(k for k in funcs if symbol in k)
                with open(os.path.join(sass_dir, f"{tree}_{route}_v8.sass"), "w") as f:
                    f.write("\n".join(" ".join(filter(None, i)) for i in funcs[name]))
        ds = data.get_dataset("italy" if spec.name == "seiard" else "synthetic_small",
                              num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        ob = torch.as_tensor(ds.observed, device=dev)
        sim = ops.make_abc_sim(ob, model=spec, **kw)
        box = spec.prior()
        ic = abc_sim.with_seed(sim.iconst, 99)
        if spec.is_regional:
            fn = entry(other_lib, abc_sim.entry_name(spec, "wave", route),
                       argtypes("regional_wave", other_gated, other_offset))
            lo = np.ascontiguousarray(box.lows, np.float32)
            hi = np.ascontiguousarray(box.highs, np.float32)
            block = abc_sim.route_block(route)

            def theirs_fn(fn=fn, sim=sim, ic=ic, ob=ob, spec=spec, box=box, lo=lo, hi=hi,
                          block=block):
                theta = torch.empty((batch, box.dim), dtype=torch.float32, device=dev)
                dist = torch.empty((batch,), dtype=torch.float32, device=dev)
                rc = fn(12, lo.ctypes.data, hi.ctypes.data, sim.obs_summary.data_ptr(),
                        sim.mob.data_ptr(), sim.weights.data_ptr(), theta.data_ptr(),
                        dist.data_ptr(), sim.fconst.ctypes.data, ic.ctypes.data, batch,
                        ob.shape[1], spec.n_regions, spec.seed_region, 0, block, stream(),
                        *([None] if other_gated else []), *([0] if other_offset else []))
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
                return theta, dist

            def mine_fn(ln=sim.launch("wave", batch, route), box=box):
                return ln(99, 12, box.lows, box.highs)
        else:
            fn = entry(other_lib, abc_sim.entry_name(spec, "wave"),
                       argtypes("wave", other_gated, other_offset))

            def theirs_fn(fn=fn, sim=sim, ic=ic, box=box):
                return call_wave(fn, box, 12, sim.obs_summary, sim.fconst, ic, batch,
                                 abc_sim.DEFAULT_BLOCK, gated=other_gated,
                                 offset=0 if other_offset else None)

            def mine_fn(ln=sim.launch("wave", batch), box=box):
                return ln(99, 12, box.lows, box.highs)
        a, b = theirs_fn(), mine_fn()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{tag}: the two trees' wave entries differ")
        once = cuda_ms_once(mine_fn)
        iters = max(2, min(30, int(300 / max(once, 1e-3))))
        timed = turns({"other": theirs_fn, "this_tree": mine_fn},
                      ["other", "this_tree", "this_tree", "other"], iters)
        out[tag] = {"batch": batch, "days": 49, "regions": spec.n_regions, "route": route,
                    "turns": timed, "ratio": timed["this_tree"]["ms"] / timed["other"]["ms"],
                    "sass_functions_identical": [same, len(theirs)], "bitwise_equal": True,
                    "iters": iters}
    return out


def cuda_ms_once(fn) -> float:
    from chip_smoke import cuda_ms

    return cuda_ms(fn, 1, warmup=1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
