#!/usr/bin/env python3
"""A two-role block for the fused ABC kernel, against the shipped one-role
kernel, on one CUDA card.

    python3 experiments/abc_sim_two_role.py

The normals of the tau-leap depend only on (seed, sample, day, transition),
never on the state, and they are most of the kernel's instructions. In the
two-role block, producer warps compute the normals of a chunk of DAYS days
for the block's S samples into a ring of STAGES shared-memory stages
([DAYS][transitions][S] floats, 8 x 5 x 128 x 4 = 20 KB at S = 128), each
stage handed over with mbarrier arrive/wait (Hopper's asynchronous
barrier); consumer threads, one a sample, run the recurrence and the
summary from the ring. The bits do not change: the same `rng::normal` is
only computed by another thread, and the consumers run the shipped
kernel's `Sample::day`. The copy includes `csrc/abc_sim_siard.cu` itself, so the
body is the shipped one.

Builds the copy (identity summary, Euclidean distance, the wave entry) into
`build/experiments/`, checks that every configuration's theta and distances
equal the shipped wave entry's bitwise at 100,000 and 1,000,000 x 49 days on
Italy, then times each configuration in turns with the shipped kernel
(one-role, two-role, two-role, one-role). The shipped design moves to two
roles only if one is at least 5% faster at 100k x 49 and no slower at
1M x 49. Prints one JSON line, then the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import sys

from abc_sim_common import build_copies, call_wave, entry, italy_inputs, turns

#: (samples a block S, producer warps, stages, days a stage)
CONFIGS = [(64, 6, 2, 8), (128, 12, 2, 8), (128, 12, 3, 8), (64, 6, 3, 4)]

SOURCE = r'''
#include "abc_sim_siard.cu"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// release (the default of mbarrier.arrive) of this thread's shared-memory writes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               ::"r"(smem_u32(bar)) : "memory");
}
// acquire (the default of try_wait) once the phase of this parity completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

template <class Model, int V, int S, int PW, int STAGES, int DAYS>
__global__ void __launch_bounds__(S + 32 * PW)
    two_role_kernel(const float* __restrict__ obs, float* __restrict__ theta_out,
                    float* __restrict__ out, int B, int T, Consts c,
                    Box<Model::N_PARAMS> box) {
  constexpr int NT = Model::N_TRANS, PRODUCERS = 32 * PW, STAGE = DAYS * NT * S;
  extern __shared__ float smem[];  // ring [STAGES][DAYS][NT][S], then obs [N_OBS, T]
  __shared__ uint64_t full[STAGES], empty[STAGES];
  float* ring = smem;
  float* obs_s = smem + STAGES * STAGE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], S);
    }
  }
  for (int i = threadIdx.x; i < Model::N_OBS * T; i += blockDim.x) obs_s[i] = obs[i];
  __syncthreads();

  const int n_chunks = (T + DAYS - 1) / DAYS;
  const int first = blockIdx.x * S;
  if (threadIdx.x >= S) {  // producer: the normals of each chunk into its stage
    const int t = threadIdx.x - S;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int st = chunk % STAGES;
      if (chunk >= STAGES) mbar_wait(&empty[st], ((chunk / STAGES) - 1) & 1);
      float* z = ring + st * STAGE;
      for (int i = t; i < STAGE; i += PRODUCERS) {
        const int smp = i % S, k = (i / S) % NT, day = chunk * DAYS + i / (S * NT);
        if (day < T)
          z[i] = rng::normal(c.seed, static_cast<uint32_t>(first + smp),
                             static_cast<uint32_t>(day) * rng::CTR_SLOTS + k);
      }
      mbar_arrive(&full[st]);
    }
  } else {  // consumer: one sample's recurrence from the ring
    const int b = first + threadIdx.x;
    const bool live = b < B;
    Sample<Model, V> s;
    if (live) {
      s.load_theta(nullptr, theta_out, b, static_cast<uint32_t>(b), B, box);
      s.start(c);
    }
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int st = chunk % STAGES;
      mbar_wait(&full[st], (chunk / STAGES) & 1);
      const float* zs = ring + st * STAGE;
      if (live) {
        for (int d = 0; d < DAYS && chunk * DAYS + d < T; ++d) {
          float z[NT];
#pragma unroll
          for (int k = 0; k < NT; ++k) z[k] = zs[(d * NT + k) * S + threadIdx.x];
          s.day(z, obs_s, chunk * DAYS + d, T, c);
        }
      }
      mbar_arrive(&empty[st]);
    }
    if (live) out[b] = s.distance(c);
  }
}

template <int S, int PW, int STAGES, int DAYS>
int launch_two_role(const Box<Siard::N_PARAMS>& box, const void* obs, void* theta, void* dist,
                    const Consts& c, int B, int T, void* stream) {
  auto kernel = two_role_kernel<Siard, WAVE, S, PW, STAGES, DAYS>;
  const size_t smem = sizeof(float) * (STAGES * DAYS * Siard::N_TRANS * S +
                                       Siard::N_OBS * static_cast<size_t>(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(B + S - 1) / S, S + 32 * PW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<float*>(theta), static_cast<float*>(dist),
      B, T, c, box);
  return cudaGetLastError();
}

}  // namespace

extern "C" int abc_sim_two_role_siard(int config, unsigned int prior_seed, const void* lows,
                                      const void* highs, const void* obs, void* theta,
                                      void* dist, const void* fconst, const void* iconst,
                                      int B, int T, void* stream) {
  const float* f = static_cast<const float*>(fconst);
  const int* i = static_cast<const int*>(iconst);
  // identity summary, Euclidean distance: the main path's pair
  if (i[I_CUMULATIVE] != 0 || i[I_LOG1P] != 0 || i[I_POWER] != 2 || i[I_ROOT] != 1 ||
      i[I_BIN_DAYS] < 1 || B <= 0 || T <= 0)
    return cudaErrorInvalidValue;
  Consts c;
  c.pop = f[F_POP];
  c.a0 = f[F_A0];
  c.r0 = f[F_R0];
  c.d0 = f[F_D0];
  c.mean_scale = f[F_MEAN_SCALE];
  for (int m = 0; m < MAX_CHAN; ++m) c.weights[m] = f[F_WEIGHTS + m];
  c.seed = static_cast<uint32_t>(i[I_SEED]);
  c.bin_days = i[I_BIN_DAYS];
  Box<Siard::N_PARAMS> box;
  for (int j = 0; j < Siard::N_PARAMS; ++j) {
    box.lo[j] = static_cast<const float*>(lows)[j];
    box.hi[j] = static_cast<const float*>(highs)[j];
  }
  box.seed = prior_seed;
  switch (config) {
CASES
    default: return cudaErrorInvalidValue;
  }
}
'''


def source() -> str:
    cases = "\n".join(
        f"    case {n}: return launch_two_role<{s}, {pw}, {st}, {d}>(box, obs, theta, dist, "
        f"c, B, T, stream);" for n, (s, pw, st, d) in enumerate(CONFIGS))
    return SOURCE.replace("CASES", cases)


def main() -> int:
    import torch

    from chip_smoke import nvidia_smi_line
    from repro_torch.kernels import abc_sim, build

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    built = build_copies([("abc_sim_two_role", source(), build.flags("abc_sim_siard"),
                           [build.CSRC])])
    lib, _, ptxas = built["abc_sim_two_role"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = entry(lib, "abc_sim_two_role_siard",
               [ci, ctypes.c_uint, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp])
    cells, smi = [], nvidia_smi_line()
    for batch, iters in ((100_000, 30), (1_000_000, 10)):
        x = italy_inputs(dev, batch)
        wave = abc_sim.launch(abc_sim_siard(), "wave", batch, obs=x["obs"], fconst=x["fconst"],
                              iconst=x["iconst"])

        def one_role():
            return wave(99, 12, x["prior"].lows, x["prior"].highs)

        want = one_role()
        fns, checks = {"one_role": one_role}, {}
        for n, cfg in enumerate(CONFIGS):
            got = call_wave(fn, x["prior"], 12, x["obs"], x["fconst"], x["iconst"], batch,
                            block=None, extra=(n,))
            torch.cuda.synchronize()
            checks[str(cfg)] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            if not checks[str(cfg)]:
                raise AssertionError(f"two-role {cfg} at {batch}: not bitwise equal to the "
                                     f"one-role kernel")
            fns[str(cfg)] = (lambda n=n: call_wave(fn, x["prior"], 12, x["obs"], x["fconst"],
                                                   x["iconst"], batch, block=None,
                                                   extra=(n,)))
        timed = {}
        for cfg in CONFIGS:
            timed[str(cfg)] = turns({"one_role": fns["one_role"], "two_role": fns[str(cfg)]},
                                    ["one_role", "two_role", "two_role", "one_role"], iters)
        cells.append({"batch": batch, "days": 49, "bitwise_equal": checks, "turns": timed,
                      "speedup": {k: v["one_role"]["ms"] / v["two_role"]["ms"]
                                  for k, v in timed.items()}})
    best = {c: (cells[0]["speedup"][str(c)], cells[1]["speedup"][str(c)]) for c in CONFIGS}
    ships = [str(c) for c, (s100k, s1m) in best.items() if s100k >= 1.05 and s1m >= 1.0]
    print(json.dumps({"experiment": "abc_sim_two_role", "configs": [
        dict(zip(("samples", "producer_warps", "stages", "days"), c)) for c in CONFIGS],
        "ptxas": ptxas, "cells": cells, "passes_the_rule": ships,
        "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    print(smi)
    return 0


def abc_sim_siard():
    from repro_torch.epi.models import get_model

    return get_model("siard")


if __name__ == "__main__":
    sys.exit(main())
