#!/usr/bin/env python3
"""This tree's `abc_sim` kernel against another checkout's, on one CUDA card.

    git archive <commit> | tar -x -C build/parent    # any directory .gitignore lists
    python3 experiments/abc_sim_parent.py build/parent

Builds `<checkout>/src/repro_torch/kernels/csrc/abc_sim.cu` (with this
tree's nvcc flags for the source, which keep `--fmad=false`) into
`build/experiments/`, then at 100,000 and 1,000,000 x 49 days on Italy:

* checks that its theta-in entry (`abc_sim_distance_siard`, the same C
  interface in both trees) gives the same distances, bit for bit, as this
  tree's theta-in and wave entries;
* times them in turns: other, this tree's theta-in, wave, wave, theta-in,
  other, each at its own tree's `DEFAULT_BLOCK`;
* counts both kernels' instructions a sample-day (`kernels/sass.py`) at the
  identity summary and gives each one's issue floor at the SM clock read
  under load.

Prints one JSON line, then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import sys

from abc_sim_common import build_copies, call_distance, entry, italy_inputs, turns


def main(argv) -> int:
    import torch

    from chip_smoke import SmClock, abc_census, nvidia_smi_line
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
    text = open(os.path.join(other_csrc, "abc_sim.cu")).read()
    lib, other_sass, ptxas = build_copies(
        [("abc_sim_other", text, build.flags("abc_sim"), [other_csrc])])["abc_sim_other"]
    fn = entry(lib, "abc_sim_distance_siard", abc_sim._ARGTYPES["distance"])
    wrapper = open(os.path.join(other_csrc, "..", "abc_sim.py")).read()
    other_block = int(re.search(r"^DEFAULT_BLOCK = (\d+)", wrapper, re.M).group(1))

    x = italy_inputs(dev, 16)
    census = {"this_tree": abc_census(build, siard, x["lowered"].flags)}
    if other_sass is not None:
        funcs = sass.parse_functions(other_sass)
        names = [k for k in funcs if "abc_sim" in k and "Siard" in k]
        census["other"] = {"function": names[0], **sass.census(funcs[names[0]])}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cells = []
    with SmClock() as clock:
        for batch, iters in ((100_000, 30), (1_000_000, 10)):
            x = italy_inputs(dev, batch)
            soa = abc_sim.theta_to_soa(x["theta"])

            def other():
                return call_distance(fn, soa, x["obs"], x["fconst"], x["iconst"], other_block)

            def theta_in():
                return abc_sim.abc_sim_distance_kernel(soa, x["obs"], x["fconst"], x["iconst"],
                                                       model=siard)

            def wave():
                return abc_sim.abc_sim_wave_kernel(12, x["prior"].lows, x["prior"].highs,
                                                   x["obs"], x["fconst"], x["iconst"],
                                                   model=siard, batch=batch)

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
            floors = {k: sass.issue_floor_ms(c, batch, 49, n_sm, mhz)["floor_ms"]
                      for k, c in (("other", census.get("other")),
                                   ("this_tree", (census["this_tree"] or {}).get("wave")))
                      if c and mhz}
            cells.append({"batch": batch, "days": 49, "bitwise_equal": equal, "turns": timed,
                          "issue_floor_ms": floors})
    smi = nvidia_smi_line()
    brief = {k: ({"per_day": v["per_day"],
                  "per_sample_outside_loop": v["per_sample_outside_loop"]["total"]}
                 if "per_day" in v else
                 {e: {"per_day": c["per_day"],
                      "per_sample_outside_loop": c["per_sample_outside_loop"]["total"]}
                  for e, c in v.items()})
             for k, v in census.items() if v}
    print(json.dumps({"experiment": "abc_sim_parent", "other": argv[0], "ptxas_other": ptxas,
                      "blocks": {"other": other_block, "this_tree": abc_sim.DEFAULT_BLOCK},
                      "census": brief, "sm_clock_mhz": clock.summary(), "sms": n_sm,
                      "cells": cells, "kind": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
