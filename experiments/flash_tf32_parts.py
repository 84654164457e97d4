#!/usr/bin/env python3
"""Where the float32 (3xTF32) flash kernel's time goes, on one CUDA card.

    python3 experiments/flash_tf32_parts.py [SOURCE]

Builds copies of `src/repro_torch/kernels/csrc/flash_attention_tf32.cu`
(or SOURCE, a copy of it) into `build/experiments/`, each with one part
taken out, and times each in turns with the whole kernel at gemma-2b's
prefill shape in float32, (4, 2048) x 8 heads, 1 kv head, D 256, causal:

  whole         the kernel as it is
  no_split      without the kernel that splits K and V into hi and lo
                tiles once a call (the products read whatever the scratch
                holds)
  no_s          without the wgmmas of s = Q K^T
  no_pv         without the wgmmas of acc += P V
  s_one_pass    s from Q_hi K_hi alone
  pv_one_pass   acc from p_hi V_hi alone
  no_copies     without the cp.async copies of the K and V tiles after the
                first (but the copies of K's last two 32-column blocks)

The parts taken out leave wrong outputs: only the times mean anything. The
time a part saves is an upper bound on what that part costs, since what is
left may then overlap differently. Prints one JSON line, then the card's
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
S_LO = ("        wg::wgmma_tf32_m64k8_rs(s, set[st][0], dl, 1);\n"
        "        wg::wgmma_tf32_m64k8_rs(s, set[st][1], dh, 1);\n")
PV_LO = ("      wg::wgmma_tf32_m64k8_rs(acc, pl[j], dh, 1);\n"
         "      wg::wgmma_tf32_m64k8_rs(acc, ph[j], dl, 1);\n")
CUTS = {
    "no_split": ["  split_kv_kernel<DP, VEC><<<dim3(p.T, p.KH, p.B), SPLIT_THREADS, 0, stream>>>(p);\n"],
    "no_s": ["        wg::wgmma_tf32_m64k8_rs(s, set[st][0], dh, 1);\n", S_LO],
    "no_pv": ["      wg::wgmma_tf32_m64k8_rs(acc, ph[j], dh, 1);\n", PV_LO],
    "s_one_pass": [S_LO],
    "pv_one_pass": [PV_LO],
    "no_copies": [
        "          copy_k_block(g - 2);\n",
        "      copy_async<2 * KVB>(sVh, img + (static_cast<size_t>(t + 1) * 4 + 2) * KVB);\n"],
}


def build_variants(src_path):
    from repro_torch.kernels import build

    src = open(src_path).read()
    os.makedirs(OUT, exist_ok=True)
    texts = {"whole": src}
    for name, cuts in CUTS.items():
        text = src
        for cut in cuts:  # a line to take out, or (text, replacement)
            old, new = cut if isinstance(cut, tuple) else (cut, "")
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not where this experiment expects it")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(OUT, f"flash_tf32_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"flash_tf32_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.flags("flash_attention_tf32"), "-I", str(build.CSRC),
             "-o", lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(lib).flash_fwd_f32_tc
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, ci, ci, ci,
                       ctypes.c_float, ctypes.c_float, vp]
        fn.restype = ci
        fns[name] = fn
        ptxas[name] = {k.split("kernel")[-1][:12]: v for k, v in build.parse_ptxas(log).items()
                       if "ILi256ELb1" in k}
    return fns, ptxas


def run(fn, q, k, v, scratch):
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    strides = np.asarray([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h,
            k.shape[2], sq, k.shape[1], d, strides.ctypes.data, 0, 1, 0, 0.0,
            float(1.0 / np.sqrt(d)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tf32_parts: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, nvidia_smi_line
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    src = argv[0] if argv else str(build.CSRC / "flash_attention_tf32.cu")
    dev = torch.device("cuda", 0)
    fns, ptxas = build_variants(src)
    rng = np.random.default_rng(2048)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
               for shape in ((4, 2048, 8, 256), (4, 2048, 1, 256), (4, 2048, 1, 256)))
    nbytes = fa._fn(fa.TENSOR_CORE_F32)[2](4, 1, 2048, 256)
    scratch = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    ms = {name: [] for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        ms[name].append(cuda_ms(lambda: run(fns[name], q, k, v, scratch), 10))
    print(json.dumps({"kind": torch.cuda.get_device_name(0), "source": src,
                      "shape": [4, 2048, 8, 1, 256], "ms": ms,
                      "mean_ms": {n: float(np.mean(t)) for n, t in ms.items()},
                      "ptxas_d256": ptxas}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
