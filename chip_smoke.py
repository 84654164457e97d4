#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its hand-written
kernel against the plain PyTorch version.

    python3 chip_smoke.py

It puts `src/` on the import path, builds the CUDA kernels from
`src/repro_torch/kernels/csrc/` with nvcc, and runs these phases, each
printing one JSON line:

  device     the card's name and the nvidia-smi name and power limit
  build      nvcc seconds and each kernel's registers, shared memory, spills
  rng        the kernel's hash bits and normals against the plain twin
  abc_sim    the fused kernel against its plain version: the r1 pins, a
             synthetic series, Italy at 100,000 x 49 days, block sizes
             64/128/256 (bitwise), and every flat (summary, distance) pair
  main_path  `repro_torch.launch.abc_run.main` on Italy at the paper's batch
             and horizon, with the launch counters set to 0 just before
  profile    the main path's waves once more under torch.profiler: wall time,
             device busy time and the operations that take it
  timing     the kernel at 100,000 and 1,000,000 x 49 days beside its bound
             and the plain version
  kernels    one line for each kernel of the main path

then the card's name and power limit as nvidia-smi gives them, and the last
line `{"ok": true, "device": {...}}`. Any failing phase raises and the
script exits non-zero; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PINS = os.path.join(ROOT, "tests", "data", "r1_pins.npz")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/abc_sim.cu"
TPU_KERNEL = "src/repro/kernels/abc_sim.py:138"
#: H100 SXM published peaks (NVIDIA's data sheet): float32 outside
#: the tensor cores, and HBM bandwidth
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: kernel-vs-plain bars (tests/test_kernel_abc_sim.py:58 and :118)
BAR = dict(rtol=2e-6, atol=1e-3)
COUNTRY_BAR = dict(rtol=1e-5, atol=1.0)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(case: str, got, want, *, rtol: float, atol: float) -> dict:
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float64)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{case}: shape {got.shape} vs {want.shape}, "
                             f"finite={np.isfinite(got).all()}")
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(
            f"{case}: {int(bad.sum())}/{bad.size} outside rtol={rtol} atol={atol}; "
            f"first at {i}: got {got.flat[i]!r} want {want.flat[i]!r}")
    rel = err / np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return {"case": case, "n": int(got.size), "max_rel_err": float(rel.max()),
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.priors import paper_prior
    from repro_torch.core.summaries import lower_summary, get_summary, summary_pairs
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim, build, ops, ref
    from repro_torch.kernels import rng as krng
    from repro_torch.launch import abc_run

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build
    t0 = time.perf_counter()
    info = build.build_all()
    emit("build", wall_s=time.perf_counter() - t0, nvcc_flags=list(build.NVCC_FLAGS),
         libraries={k: {"nvcc_s": v.seconds, "cached": v.cached, "kernels": v.kernels}
                    for k, v in info.items()})

    # ---- rng: the kernel's hash bits and normals against the plain twin
    B, C, seed = 1_000_000, 10, 0x5EED1234
    idx = torch.arange(B, device=dev)[:, None]
    ctr = torch.arange(C, device=dev)[None, :]
    bits_k = abc_sim.rng_normals(seed, B, C, bits=True, device=dev)
    bits_p = krng.hash_u32(seed, idx, ctr)
    if not torch.equal(bits_k, bits_p):
        raise AssertionError(f"rng: {int((bits_k != bits_p).sum())} hash words differ")
    z_k = abc_sim.rng_normals(seed, B, C, device=dev)
    z_p = krng.normal(seed, idx, ctr)
    z_err = float((z_k - z_p).abs().max())
    if not z_err <= 1e-6:
        raise AssertionError(f"rng: normals differ by {z_err} > 1e-6")
    emit("rng", shape=[B, C], hash_bits_equal=True, normals_max_abs_err=z_err,
         normals_atol=1e-6, normals_bitwise_equal_share=float((z_k == z_p).double().mean()))

    # ---- abc_sim: kernel against its plain version on the card
    siard = get_model("siard")
    results = []

    def on_card(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def both(theta, seed, observed, kw, **extra):
        th, ob = on_card(theta), on_card(observed)
        d_k = ops.abc_sim_distance(th, seed, ob, model=siard, **kw, **extra)
        d_p = ref.abc_sim_distance_ref(th, seed, ob, model=siard, **kw, **extra)
        return d_k, d_p

    pins = np.load(PINS)
    pop, a0, r0, d0, _ = data.SYNTH_SMALL_META
    small_kw = dict(population=pop, a0=a0, r0=r0, d0=d0)
    d_k, d_p = both(pins["siard/theta"], 123, pins["siard/observed"], small_kw)
    results.append(compare("pins 16x14 kernel vs plain", d_k, d_p, **BAR))
    for key in ("oracle", "pallas"):
        results.append(compare(f"pins 16x14 kernel vs siard/{key}", d_k,
                               pins[f"siard/{key}"], **BAR))

    small = data.get_dataset("synthetic_small", num_days=49)
    th_small = paper_prior().sample(11, 1024, dev)
    d_k, d_p = both(th_small, 77, small.observed, small_kw)
    results.append(compare("synthetic_small 1024x49 kernel vs plain", d_k, d_p, **BAR))

    italy = data.get_dataset("italy", num_days=49)
    it_kw = dict(population=italy.population, a0=italy.a0, r0=italy.r0, d0=italy.d0)
    th_it = paper_prior().sample(12, 100_000, dev)
    d_it, d_p = both(th_it, 99, italy.observed, it_kw)
    results.append(compare("italy 100000x49 kernel vs plain", d_it, d_p, **COUNTRY_BAR))
    ob_it = torch.as_tensor(italy.observed, device=dev)
    for block in (64, 128, 256):
        d_b = ops.abc_sim_distance(th_it, 99, ob_it, model=siard, block=block, **it_kw)
        if not torch.equal(d_b, d_it):
            raise AssertionError(f"block {block}: distances differ from block 128")
    for s, dist in summary_pairs():
        d_k, d_p = both(th_small, 77, small.observed, small_kw, summary=s, distance=dist)
        results.append(compare(f"{s}/{dist} 1024x49 kernel vs plain", d_k, d_p, **BAR))
    emit("abc_sim", comparisons=results, block_sizes_bitwise_equal=[64, 128, 256])
    max_abs_err = max(r["max_abs_err"] for r in results
                      if r["case"].endswith("kernel vs plain"))

    # ---- main_path: the port's CLI on the card, counters read around it
    argv = ["--dataset", "italy", "--days", "49", "--batch", "100000",
            "--chunk", "10000", "--auto-tolerance", "1e-4", "--accept", "100",
            "--device", "cuda"]
    abc_sim.LAUNCHES = 0
    ref.CALLS = 0
    t0 = time.perf_counter()
    post = abc_run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = abc_sim.LAUNCHES, ref.CALLS
    if launches == 0 or plain_calls != 0:
        raise AssertionError(f"main path: {launches} kernel launches, "
                             f"{plain_calls} plain-version calls")
    prior = siard.prior()
    lo, hi = np.asarray(prior.lows), np.asarray(prior.highs)
    theta = post.theta
    if (len(post) < 100 or theta.shape[1] != 8 or not np.isfinite(theta).all()
            or not np.isfinite(post.distances).all()
            or (post.distances > post.tolerance).any()
            or (theta < lo).any() or (theta > hi).any()):
        raise AssertionError(f"main path: bad posterior ({len(post)} samples)")
    truth = np.asarray(data.TABLE8_THETA["italy"])
    err = np.abs(theta.mean(axis=0) - truth) / (hi - lo)
    prior_err = np.abs((hi + lo) / 2 - truth) / (hi - lo)
    if not err.mean() < prior_err.mean():
        raise AssertionError(f"main path: posterior mean error {err.mean()} is not "
                             f"below the prior mean's {prior_err.mean()}")
    emit("main_path", argv=argv, kernel_launches=launches, plain_calls=plain_calls,
         accepted=len(post), waves=post.runs, simulations=post.simulations,
         tolerance=post.tolerance, wall_s=wall, kind=name, nvidia_smi=smi,
         posterior_mean=dict(zip(siard.param_names, theta.mean(axis=0).tolist())),
         generating_theta=dict(zip(siard.param_names, truth.tolist())),
         normalized_mean_error=err.mean().item(),
         prior_mean_normalized_error=prior_err.mean().item())

    # ---- profile: where the main path's waves spend their time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.abc import ABCConfig, run_abc

    cfg = ABCConfig(batch_size=100_000, chunk_size=10_000, num_days=49,
                    tolerance=post.tolerance, target_accepted=100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = run_abc(italy, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side events only (kernels and copies); the host ops that
    # launched them carry the same time again
    by_op = sorted(((e.key, e.count, device_us(e)) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in by_op) / 1e3
    emit("profile", wall_ms=wall * 1e3, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3), waves=again.runs,
         accepted=len(again), kind=name, nvidia_smi=smi,
         top_device_ops=[{"name": k[:80], "count": c, "device_ms": us / 1e3}
                         for k, c, us in by_op[:8]])

    # ---- timing: the kernel alone, beside its bound and the plain version
    lowered = lower_summary(get_summary(None), "euclidean", ob_it)
    fconst, iconst = abc_sim.pack_consts(
        mean_scale=lowered.mean_scale, weights=lowered.weights.cpu().numpy(),
        flags=lowered.flags, seed=99, **it_kw)
    ops_sd = abc_sim.ops_per_sample_day(siard, lowered)
    timing = []
    for batch, kernel_iters, plain_iters in ((100_000, 50, 2), (1_000_000, 20, 1)):
        th = th_it if batch == 100_000 else paper_prior().sample(13, batch, dev)
        soa = abc_sim.theta_to_soa(th)
        obs = lowered.obs_summary.contiguous()
        ms = cuda_ms(lambda: abc_sim.abc_sim_distance_kernel(
            soa, obs, fconst, iconst, model=siard), kernel_iters)
        plain_ms = cuda_ms(lambda: ref.abc_sim_distance_ref(
            th, 99, ob_it, model=siard, **it_kw), plain_iters, warmup=1)
        n_ops = ops_sd * batch * 49
        n_bytes = abc_sim.bytes_moved(siard, batch, 49)
        ops_ms, bytes_ms = n_ops / F32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        timing.append({"batch": batch, "days": 49, "ms": ms, "plain_ms": plain_ms,
                       "ops": n_ops, "bytes": n_bytes, "ops_per_sample_day": ops_sd,
                       "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                       "share_of_bound": max(ops_ms, bytes_ms) / ms,
                       "sample_days_per_s": batch * 49 / (ms * 1e-3),
                       "iters": kernel_iters, "plain_iters": plain_iters})
    emit("timing", kind=name, nvidia_smi=smi, peak_ops_per_s=F32_OPS_PER_S,
         peak_bytes_per_s=HBM_BYTES_PER_S, library_ms=None, cells=timing)

    main_cell = timing[0]
    print(json.dumps({"kernels": [{
        "name": "abc_sim_distance", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_cell["ms"], "plain_ms": main_cell["plain_ms"],
        "bound_ms": main_cell["bound_ms"], "bound_by": main_cell["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
