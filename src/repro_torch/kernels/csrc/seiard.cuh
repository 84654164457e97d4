// SEIARD, the paper's SIARD model with an exposed stage
// (src/repro/epi/models/seiard.py:30-51), as a struct the fused kernel is
// templated on. State X = [S, E, I, A, R, D, Ru], theta = [alpha0, alpha, n,
// beta, gamma, delta, eta, kappa, epsilon]; transitions S->E, E->I, I->A,
// A->R, A->D, I->Ru in clamp order. Every product is written in the order of
// the Python rows (src/repro_torch/epi/models/seiard.py), so the float32
// roundings agree with the plain version.
#pragma once

struct Seiard {
  static constexpr int N_STATE = 7;
  static constexpr int N_TRANS = 6;
  static constexpr int N_PARAMS = 9;
  static constexpr int N_OBS = 3;
  // Tables as constexpr functions, as in siard.cuh. observed compartments (A, R, D)
  __host__ __device__ static constexpr int observed(int m) {
    constexpr int t[N_OBS] = {3, 4, 5};
    return t[m];
  }
  __host__ __device__ static constexpr int src(int k) {
    constexpr int t[N_TRANS] = {0, 1, 2, 3, 3, 2};
    return t[k];
  }
  __host__ __device__ static constexpr int dst(int k) {
    constexpr int t[N_TRANS] = {1, 2, 3, 4, 5, 6};
    return t[k];
  }

  // I0 = E0 = kappa * A0, Ru = 0, S = P - (A0 + R0 + D0 + I0 + E0).
  __device__ __forceinline__ static void initial(const float* p, float pop, float a0,
                                                 float r0, float d0, float* x) {
    const float i0 = p[7] * a0;
    const float e0 = p[7] * a0;
    x[0] = pop - (a0 + r0 + d0 + i0 + e0);
    x[1] = e0;
    x[2] = i0;
    x[3] = a0;
    x[4] = r0;
    x[5] = d0;
    x[6] = 0.0f;
  }

  // Eq. (4)-(5) with the latent stage, before the clamp at zero.
  __device__ __forceinline__ static void hazards(const float* x, const float* p, float pop,
                                                 float* h) {
    float ard = x[3] + x[4] + x[5];
    ard = ard < 0.0f ? 0.0f : ard;
    const float g = p[0] + p[1] / (1.0f + powf(ard, p[2]));
    h[0] = g * x[0] * x[2] / pop;  // S -> E
    h[1] = p[8] * x[1];            // E -> I
    h[2] = p[4] * x[2];            // I -> A
    h[3] = p[3] * x[3];            // A -> R
    h[4] = p[5] * x[3];            // A -> D
    h[5] = p[3] * p[6] * x[2];     // I -> Ru
  }
};
