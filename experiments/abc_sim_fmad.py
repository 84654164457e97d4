#!/usr/bin/env python3
"""What `--fmad=false` costs the fused ABC kernel, on one CUDA card.

    python3 experiments/abc_sim_fmad.py

`csrc/abc_sim_siard.cu` is built with `--fmad=false`, so that no multiply and add
of the kernel's own code are contracted into one rounding: h + sqrt(h) * z,
the accumulator update and low + u * width round as the plain PyTorch
version does, and the distances are bitwise equal to it. This builds a copy
of the source with contraction on (`--fmad=true`, nvcc's default) into
`build/experiments/`, for timing only, and reports:

* both copies' instruction census (`kernels/sass.py`) at the main path's
  variant (wave entry, identity summary, Euclidean distance);
* their times in turns (shipped, fmad, fmad, shipped) at 100,000 and
  1,000,000 x 49 days on Italy;
* how many thetas and distances of the contracted copy differ from the
  shipped kernel (itself bitwise equal to the plain version) there and on
  every flat (summary, distance) pair at 1024 x 49 on synthetic_small, and
  how far.

Prints one JSON line, then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from abc_sim_common import ARGTYPES, build_copies, call_wave, entry, italy_inputs, turns


def differ(got, want) -> dict:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    bad = g.view(np.uint32) != w.view(np.uint32)
    fin = np.isfinite(g) & np.isfinite(w)
    rel = np.abs(g - w)[fin] / np.maximum(np.abs(w[fin]), 1e-30)
    return {"n": int(bad.size), "differ": int(bad.sum()),
            "max_rel": float(rel.max()) if rel.size else 0.0}


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi_line
    from repro_torch.core.summaries import get_summary, lower_summary, summary_pairs
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim, build, ops, sass

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    siard = get_model("siard")
    flags = [f if f != "--fmad=false" else "--fmad=true" for f in build.flags("abc_sim_siard")]
    src = (build.CSRC / "abc_sim_siard.cu").read_text()
    built = build_copies([("abc_sim_fmad", src, flags, [build.CSRC])])
    lib, fmad_sass, ptxas = built["abc_sim_fmad"]
    fn = entry(lib, "abc_sim_wave_siard", ARGTYPES["wave"])

    main_flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    symbol = abc_sim.kernel_symbol(siard, main_flags, True)
    census = {}
    for tag, text in (("shipped", build.sass_text("abc_sim_siard")), ("fmad", fmad_sass)):
        if text is None:
            continue
        funcs = sass.parse_functions(text)
        name = next(k for k in funcs if symbol in k)
        c = sass.census(funcs[name])
        census[tag] = {"per_day": c["per_day"],
                       "per_sample_outside_loop": c["per_sample_outside_loop"]["total"]}

    cells = []
    for batch, iters in ((100_000, 30), (1_000_000, 10)):
        x = italy_inputs(dev, batch)
        wave = abc_sim.launch(siard, "wave", batch, obs=x["obs"], fconst=x["fconst"],
                              iconst=x["iconst"])

        def shipped():
            return wave(99, 12, x["prior"].lows, x["prior"].highs)

        def fmad():
            return call_wave(fn, x["prior"], 12, x["obs"], x["fconst"], x["iconst"], batch,
                             gated=True, offset=0)

        want, got = shipped(), fmad()
        timed = turns({"shipped": shipped, "fmad": fmad},
                      ["shipped", "fmad", "fmad", "shipped"], iters)
        cells.append({"batch": batch, "days": 49, "turns": timed,
                      "speedup": timed["shipped"]["ms"] / timed["fmad"]["ms"],
                      "theta": differ(got[0], want[0]), "distances": differ(got[1], want[1])})

    small = data.get_dataset("synthetic_small", num_days=49)
    pop, a0, r0, d0, _ = data.SYNTH_SMALL_META
    observed = torch.as_tensor(small.observed, device=dev)
    pairs = {}
    for s, d in summary_pairs():
        sim = ops.make_abc_sim(observed, model=siard, summary=s, distance=d, population=pop,
                               a0=a0, r0=r0, d0=d0)
        want = sim.wave(x["prior"], 11, 77, 1024)
        got = call_wave(fn, x["prior"], 11, sim.obs_summary, sim.fconst,
                        abc_sim.with_seed(sim.iconst, 77), 1024, gated=True, offset=0)
        pairs[f"{s}/{d}"] = differ(got[1], want[1])
    smi = nvidia_smi_line()
    print(json.dumps({"experiment": "abc_sim_fmad", "nvcc_flags": flags, "ptxas": ptxas,
                      "census": census, "cells": cells, "pairs_1024x49": pairs,
                      "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
