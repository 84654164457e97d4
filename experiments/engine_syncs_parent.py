#!/usr/bin/env python3
"""The plain engine's host syncs and wall, this tree against another
checkout's, on one CUDA card.

    git archive <commit> src/repro_torch | tar -x -C build/parent
    python3 experiments/engine_syncs_parent.py build/parent

Each tree runs in its own process (the package names are the same), in
turns: other, this tree, this tree, other. A process times two workloads
of `repro_torch.epi.engine` on the card with the host clock around work
that ends in a synchronise, after two warm-up calls:

* `npe_step_sim`: what an NPE training step of `configs/epi_abc.npe_demo`
  simulates (`prior.sample` of 256, `simulate_observed` of sir over 15
  days, `summary_features`), 50 calls;
* `forecast`: `simulate_observed` of SIARD, 8,000 samples x 63 days on the
  Italy scalars (the size of one batched serving call), 5 calls;

and counts, for one more call of each, the operations PyTorch reports as
synchronizing (`torch.cuda.set_sync_debug_mode("warn")`): a copy of a host
value to the card is followed by a stream sync, which stalls the host until
the card has drained its queue. Prints one JSON line, then the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys, time, warnings
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.summaries import get_summary, summary_features
from repro_torch.epi import engine
from repro_torch.epi.models import get_model
from repro_torch.epi.spec import EpiModelConfig

dev = torch.device("cuda", 0)
sir, siard = get_model("sir"), get_model("siard")
small = EpiModelConfig(population=1e6, num_days=15, a0=100.0, r0=0.0, d0=0.0)
italy = EpiModelConfig(population=60.36e6, num_days=63, a0=2.0, r0=0.0, d0=0.0)
th_fc = siard.prior().sample(3, 8000, dev)


def npe_step_sim(i):
    th = sir.prior().sample(i, 256, dev)
    summary_features(get_summary(None), engine.simulate_observed(sir, th, i + 1, small), 1)


def forecast(i):
    engine.simulate_observed(siard, th_fc, i, italy)


out = {"tree": sys.argv[1]}
for name, fn, n in (("npe_step_sim", npe_step_sim, 50), ("forecast", forecast, 5)):
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(10 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(99)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    out[name] = {"ms": ms, "calls": n, "host_syncs_a_call": syncs}
print(json.dumps(out))
"""


def run(tree: str) -> dict:
    src = os.path.join(tree, "src")
    res = subprocess.run([sys.executable, "-c", WORKER, src], capture_output=True, text=True,
                         timeout=600, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    other = os.path.abspath(sys.argv[1])
    runs = [run(t) for t in (other, ROOT, ROOT, other)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"other": other, "runs": runs, "nvidia_smi": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
