// The stochastic SIR model (src/repro/epi/models/sir.py:21-36) as a struct
// the fused kernel is templated on. State X = [S, I, R], theta = [beta,
// gamma, kappa]; transitions S->I, I->R. Every product is written in the
// order of the Python rows (src/repro_torch/epi/models/sir.py), so the
// float32 roundings agree with the plain version.
#pragma once

struct Sir {
  static constexpr int N_STATE = 3;
  static constexpr int N_TRANS = 2;
  static constexpr int N_PARAMS = 3;
  static constexpr int N_OBS = 2;
  // Tables as constexpr functions, as in siard.cuh: indices fold to
  // constants in the kernel's unrolled loops. observed compartments (I, R)
  __host__ __device__ static constexpr int observed(int m) {
    constexpr int t[N_OBS] = {1, 2};
    return t[m];
  }
  __host__ __device__ static constexpr int src(int k) {
    constexpr int t[N_TRANS] = {0, 1};
    return t[k];
  }
  __host__ __device__ static constexpr int dst(int k) {
    constexpr int t[N_TRANS] = {1, 2};
    return t[k];
  }

  // I0 = kappa * A0, R0 from the dataset, S = P - (I0 + R0).
  __device__ __forceinline__ static void initial(const float* p, float pop, float a0,
                                                 float r0, float /*d0*/, float* x) {
    const float i0 = p[2] * a0;
    x[0] = pop - (i0 + r0);
    x[1] = i0;
    x[2] = r0;
  }

  // before the clamp at zero
  __device__ __forceinline__ static void hazards(const float* x, const float* p, float pop,
                                                 float* h) {
    h[0] = p[0] * x[0] * x[1] / pop;  // S -> I
    h[1] = p[1] * x[1];               // I -> R
  }
};
