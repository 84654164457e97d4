#!/usr/bin/env python3
"""What the bf16 flash kernel's hi + lo split of p buys, on one CUDA card.

    python3 experiments/flash_p_rounding.py

Builds two copies of `src/repro_torch/kernels/csrc/flash_attention_wgmma.cu`
into `build/experiments/`: the kernel as shipped (p multiplied into V as bf16
hi + lo) and a copy without the lo product (p rounded once to bf16, as SDPA
and FlashAttention-3 do). Each runs every bf16 case of chip_smoke.py's
FLASH_CASES against the plain version at the kernel's bar (rtol 2^-7, atol
3e-5) and reports the largest error and the elements outside the bar; then
both are timed with CUDA events at gemma-2b's prefill shapes, in turns
(shipped, single, single, shipped). Prints one JSON line, then the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "experiments")
LO_PASS = "        wg::wgmma_m64k16_rs(acc, pl[kk], dv, 1);\n"


def build_variants():
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    if src.count(LO_PASS) != 1:
        raise RuntimeError("the lo product of p is not where this experiment expects it")
    os.makedirs(OUT, exist_ok=True)
    libs, procs = {}, []
    for name, text in (("hi_lo", src), ("single", src.replace(LO_PASS, ""))):
        cu = os.path.join(OUT, f"flash_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(OUT, f"flash_{name}.so")
        procs.append(subprocess.Popen([build.nvcc_path(), *build.flags("flash_attention_wgmma"),
                                       "-I", str(build.CSRC), "-o", libs[name], cu],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).flash_fwd_bf16
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, ci, ci, ci, ctypes.c_float,
                       ctypes.c_float, vp]
        fn.restype = ci
        fns[name] = fn
    return fns


def run(fn, q, k, v, causal, window, softcap):
    import torch

    from repro_torch.kernels.flash_attention import staged

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    strides = np.asarray([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    by_element = staged(q.dtype, d, strides.tolist(), [t.data_ptr() for t in (q, k, v, out)])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[2], sq,
            k.shape[1], d, strides.ctypes.data, int(by_element), int(causal), window or 0,
            softcap or 0.0, float(1.0 / np.sqrt(d)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_p_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import FLASH_CASES, cuda_ms, nvidia_smi_line
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    fns = build_variants()
    rtol, atol = 2**-7, 3e-5
    cases = []
    for case in FLASH_CASES:
        b, sq, h, kh, d, skv, causal, window, cap = case
        rng = np.random.default_rng(sq + h)
        q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32))
                   .to(device=dev, dtype=torch.bfloat16)
                   for s in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d)))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=cap).double()
        row = {"case": list(case)}
        for name, fn in fns.items():
            got = run(fn, q, k, v, causal, window, cap).double()
            err = (got - want).abs()
            bad = err > atol + rtol * want.abs()
            row[name] = {"max_abs_err": float(err.max()), "outside_bar": int(bad.sum()),
                         "n": bad.numel()}
        cases.append(row)
    timing = []
    for b, s, iters in ((4, 2048, 20), (1, 8192, 10)):
        rng = np.random.default_rng(s)
        q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
                   .to(device=dev, dtype=torch.bfloat16)
                   for shape in ((b, s, 8, 256), (b, s, 1, 256), (b, s, 1, 256)))
        ms = {name: [] for name in fns}
        for name in ("hi_lo", "single", "single", "hi_lo"):
            ms[name].append(cuda_ms(lambda: run(fns[name], q, k, v, True, None, None), iters))
        flops = fa.attention_flops(b, s, s, 8, 256)
        timing.append({"batch": b, "seq": s, "iters": iters, "ms": ms,
                       "bound_ms": flops / 989e12 * 1e3})
    print(json.dumps({"kind": torch.cuda.get_device_name(0), "bar": {"rtol": rtol, "atol": atol},
                      "cases": cases, "timing": timing}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
