#!/usr/bin/env python3
"""The census of a sample-day of the region axis under forms of the device gate.

    python3 experiments/abc_sim_gate_census.py

Builds copies of `csrc/abc_sim_regional_metapop_seir.cu` into
`build/experiments/`, each with the gate line of the warp route
(`csrc/abc_sim_regional_warp.cuh`) written another way: as shipped, not
read at all (the argument kept), read through `__ldg`, as a nested test,
through a volatile pointer, and merged into the kernel's `b >= B` return
after the staging. For each it prints the warp route's warp-instructions a
sample-day at R=100 (`sass.regional_warp_census`), those outside the day
loop, the thread route's instructions a sample-day at R=4
(`sass.regional_census`) and the warp variants' registers, and writes the
main path's warp variant's SASS beside the copies. One JSON line, then the
card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

from abc_sim_common import OUT, build_copies

SHIPPED = "  if (gate != nullptr && *gate == 0) return;  // the same in every thread\n"
RETURN = "  if (b >= B) return;  // the whole warp\n"
FORMS = {
    "shipped": SHIPPED,
    "not_read": "",
    "ldg": "  if (gate != nullptr && __ldg(gate) == 0) return;\n",
    "nested": "  if (gate != nullptr) {\n    if (*gate == 0) return;\n  }\n",
    "volatile": "  if (gate != nullptr && *static_cast<const volatile int*>(gate) == 0) return;\n",
    "after_staging": None,
}


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi_line
    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim, build, sass

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    metapop = get_model("metapop_seir")
    lib = abc_sim.library(metapop)
    jobs = []
    for form, line in FORMS.items():
        csrc = os.path.join(OUT, f"gate_{form}")
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(build.CSRC, csrc)
        path = os.path.join(csrc, "abc_sim_regional_warp.cuh")
        text = open(path).read()
        if SHIPPED not in text or RETURN not in text:
            raise RuntimeError(f"{path}: the gate line or the warp's return moved")
        if line is None:
            text = text.replace(SHIPPED, "").replace(
                RETURN, "  if (b >= B || (gate != nullptr && *gate == 0)) return;\n")
        else:
            text = text.replace(SHIPPED, line)
        with open(path, "w") as f:
            f.write(text)
        jobs.append((f"gate_{form}", open(os.path.join(csrc, lib + ".cu")).read(),
                     build.flags(lib), [csrc]))
    out = {}
    for form, (_, text, ptxas) in build_copies(jobs).items():
        if text is None:
            raise RuntimeError("the toolkit has no cuobjdump")
        funcs = sass.parse_functions(text)
        warp, thread = (next(f for k, f in funcs.items()
                             if abc_sim.kernel_symbol(metapop, flags, True, route) in k)
                        for route in ("warp", "thread"))
        census = sass.regional_warp_census(warp, True)
        out[form.removeprefix("gate_")] = {
            "warp_R100_per_day": sass.regional_warp_per_day(census, 100, 200)["total"],
            "warp_outside_loop": census["per_sample_outside_loop"]["total"],
            "thread_R4_per_day": sass.regional_per_day(sass.regional_census(thread, True),
                                                       4, 4)["total"],
            "warp_registers": sorted({k["registers"] for n, k in ptxas.items()
                                      if "warp_kernel" in n}),
            "warp_sass_lines": len(warp)}
        with open(os.path.join(OUT, f"{form}_warp_v8.sass"), "w") as f:
            f.write("\n".join(f"{i.pred} {i.opcode} {i.operands}" for i in warp))
    smi = nvidia_smi_line()
    print(json.dumps({"experiment": "abc_sim_gate_census", "forms": out,
                      "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
