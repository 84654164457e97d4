#!/usr/bin/env python3
"""The float32 flash kernel on the CUDA cores, beside the 3xTF32 one that
replaced it on the route, on one CUDA card.

    python3 experiments/flash_f32_cuda_core.py

Builds `experiments/flash_f32_cuda_core.cu` (the float32 route up to the
tensor-core kernel `src/repro_torch/kernels/csrc/flash_attention_tf32.cu`,
with the flash sources' nvcc flags) into `build/experiments/`, holds it to
the plain version on every case of chip_smoke.py's FLASH_CASES at the
float32 bar, then times it in turns with the shipped float32 route (tf32,
cuda_core, cuda_core, tf32) at gemma-2b's prefill shapes, (4, 2048) and
(1, 8192) x 8 heads, 1 kv head, D 256, causal. Prints one JSON line, then
the card's nvidia-smi name and power limit.

chip_smoke.py builds and times the same kernel through `start_build`,
`finish_build` and `run`, so that both kernels' times come from one call.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "experiments", "flash_f32_cuda_core.cu")
OUT = os.path.join(ROOT, "build", "experiments")
LIB = os.path.join(OUT, "flash_f32_cuda_core.so")


def start_build() -> subprocess.Popen:
    """Start nvcc on the CUDA-core kernel; `finish_build` waits for it."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    return subprocess.Popen(
        [build.nvcc_path(), *build.flags("flash_attention_tf32"), "-o", LIB, SOURCE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen):
    """(entry `flash_fwd_f32`, ptxas report by kernel) once nvcc is done."""
    from repro_torch.kernels import build

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
    fn = ctypes.CDLL(LIB).flash_fwd_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, ci, ci, ctypes.c_float,
                   ctypes.c_float, vp]
    fn.restype = ci
    return fn, build.parse_ptxas(log)


def run(fn, q, k, v, *, causal=True, window=None, softcap=None):
    """o [B, Sq, H, D] float32 from the CUDA-core kernel on the current stream."""
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    strides = np.asarray([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[2], sq,
            k.shape[1], d, strides.ctypes.data, int(causal), window or 0, softcap or 0.0,
            float(1.0 / np.sqrt(d)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_f32 launch failed: cudaError {rc}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_cuda_core: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import FLASH_BARS, FLASH_CASES, compare, cuda_ms, nvidia_smi_line
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fn, ptxas = finish_build(start_build())
    cases = []
    for case in FLASH_CASES:
        b, sq, h, kh, d, skv, causal, window, cap = case
        rng = np.random.default_rng(sq + h)
        q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32), device=dev)
                   for s in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d)))
        kw = dict(causal=causal, window=window, softcap=cap)
        want = ref.flash_attention_ref(q, k, v, **kw)
        cases.append(compare(f"cuda_core {case}", run(fn, q, k, v, **kw), want,
                             **FLASH_BARS["float32"]))
    timing = []
    for b, s, iters in ((4, 2048, 5), (1, 8192, 2)):
        rng = np.random.default_rng(s)
        q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
                   for shape in ((b, s, 8, 256), (b, s, 1, 256), (b, s, 1, 256)))
        calls = {"tf32": lambda: fa.flash_attention_kernel(q, k, v, causal=True),
                 "cuda_core": lambda: run(fn, q, k, v, causal=True)}
        ms = {name: [] for name in calls}
        for name in ("tf32", "cuda_core", "cuda_core", "tf32"):
            ms[name].append(cuda_ms(calls[name], iters))
        timing.append({"batch": b, "seq": s, "iters": iters, "ms": ms})
        del q, k, v
    print(json.dumps({"kind": torch.cuda.get_device_name(0), "ptxas": ptxas, "cases": cases,
                      "timing": timing}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
