#!/usr/bin/env python3
"""The device wave loop's compaction on the card: the kernel
(`kernels.compact`, `csrc/abc_compact.cu`) against the plain PyTorch lines
of `core.abc.compact_plain`, which `compact_accepted` runs for CPU tensors
(and ran on the card before the kernel), at the main path's shapes.

    python3 experiments/abc_compact_timing.py [--out chiprun_out/compact_timing.json]

For B = 1,000,000 and 4,000,000 rows of 8 parameters, an accept mask with
about 12 accepted rows (the benchmark's 1e-5 quantile) and a gated one (all
false): the device us a call, by CUDA events over 100 calls enqueued
behind a `torch.cuda._sleep`, so that the events time the card and not the
host's enqueue (three turns: kernel, plain, plain, kernel...), and the
host us to enqueue one call. The mask stays in L2 between calls, as it
does after the compare that makes it. Bound: the mask's bytes and the
accepted rows' bytes read and written, at 3.35 TB/s. One JSON object, then
the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CALLS = 100
TURNS = 3
HBM_BYTES_PER_S = 3.35e12


def device_us(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / CALLS


def host_us(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / CALLS


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi_line
    from repro_torch.core.abc import compact_plain
    from repro_torch.ioutils import atomic_write_text
    from repro_torch.kernels import compact

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "compact_timing.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    p, rows = 8, {}
    for batch in (1_000_000, 4_000_000):
        gen = torch.Generator(device=dev).manual_seed(batch)
        theta = torch.rand((batch, p), device=dev, generator=gen)
        dist = torch.rand((batch,), device=dev, generator=gen)
        cap = batch + 100
        th_buf = torch.zeros((cap + 1, p), device=dev)
        d_buf = torch.full((cap + 1,), float("inf"), device=dev)
        fill = torch.zeros((1,), dtype=torch.int64, device=dev)
        masks = {"ungated": dist <= 12.0 / batch,
                 "gated": torch.zeros((batch,), dtype=torch.bool, device=dev)}
        for gate, accept in masks.items():
            n = int(accept.sum())
            fns = {
                "kernel": lambda a=accept: compact.compact_rows(th_buf, d_buf, fill, theta, dist,
                                                                a, cap),
                "plain": lambda a=accept: compact_plain(th_buf, d_buf, fill, theta, dist, a, cap),
            }
            for fn in fns.values():
                fn()
            dev_us = {k: [] for k in fns}
            for turn in range(TURNS):
                for k in ("kernel", "plain") if turn % 2 == 0 else ("plain", "kernel"):
                    dev_us[k].append(device_us(fns[k]))
            bound_us = (batch + n * (p + 1) * 4 * 2 + 16) / HBM_BYTES_PER_S * 1e6
            rows[f"{batch}/{gate}"] = {
                "accepted": n, "bound_us": bound_us,
                "kernel_us": dev_us["kernel"], "plain_us": dev_us["plain"],
                "kernel_host_us": host_us(fns["kernel"]), "plain_host_us": host_us(fns["plain"]),
            }
    out = {"calls": CALLS, "rows": rows, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    atomic_write_text(args.out, json.dumps(out, indent=1))
    print(json.dumps(out))
    print(out["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
