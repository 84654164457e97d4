// The paper's SIARD model (src/repro/epi/models/siard.py:34-71) as a struct
// the fused kernel is templated on. State X = [S, I, A, R, D, Ru], theta =
// [alpha0, alpha, n, beta, gamma, delta, eta, kappa]; transitions S->I,
// I->A, A->R, A->D, I->Ru in clamp order. Every product is written in the
// order of the Python rows, so the float32 roundings agree with the plain
// version (src/repro_torch/epi/models/siard.py).
//
// Each other flat model (sir.cuh, seir.cuh, seiard.cuh) is one more struct
// with the same members; the kernel template (abc_sim.cuh) does not change.
#pragma once

struct Siard {
  static constexpr int N_STATE = 6;
  static constexpr int N_TRANS = 5;
  static constexpr int N_PARAMS = 8;
  static constexpr int N_OBS = 3;
  // Tables as constexpr functions: device code may not take the address of
  // a constexpr member array, and with the kernel's loops unrolled every
  // call folds to a constant, so state indices stay register names.
  // observed compartments (A, R, D)
  __host__ __device__ static constexpr int observed(int m) {
    constexpr int t[N_OBS] = {2, 3, 4};
    return t[m];
  }
  // source (-1) and destination (+1) compartment of each stoichiometry row
  __host__ __device__ static constexpr int src(int k) {
    constexpr int t[N_TRANS] = {0, 1, 2, 2, 1};
    return t[k];
  }
  __host__ __device__ static constexpr int dst(int k) {
    constexpr int t[N_TRANS] = {1, 2, 3, 4, 5};
    return t[k];
  }

  // Paper step 1: Ru = 0, I0 = kappa * A0, S = P - (A0 + R0 + D0 + I0).
  __device__ __forceinline__ static void initial(const float* p, float pop, float a0,
                                                 float r0, float d0, float* x) {
    const float i0 = p[7] * a0;
    x[0] = pop - (a0 + r0 + d0 + i0);
    x[1] = i0;
    x[2] = a0;
    x[3] = r0;
    x[4] = d0;
    x[5] = 0.0f;
  }

  // Eq. (4)-(5), before the clamp at zero.
  __device__ __forceinline__ static void hazards(const float* x, const float* p, float pop,
                                                 float* h) {
    float ard = x[2] + x[3] + x[4];
    ard = ard < 0.0f ? 0.0f : ard;
    const float g = p[0] + p[1] / (1.0f + powf(ard, p[2]));
    h[0] = g * x[0] * x[1] / pop;  // S -> I
    h[1] = p[4] * x[1];            // I -> A
    h[2] = p[3] * x[2];            // A -> R
    h[3] = p[5] * x[2];            // A -> D
    h[4] = p[3] * p[6] * x[1];     // I -> Ru
  }
};
