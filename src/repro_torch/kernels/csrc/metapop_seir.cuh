// The spatial metapopulation SEIR model (src/repro/epi/models/metapop_seir.py:37-53)
// as a struct the regional kernel (abc_sim_regional.cuh) is templated on.
// One region's state X = [S, E, I, R], theta = [beta, sigma, gamma, kappa];
// transitions S->E, E->I, I->R. Its exposure reads the coupled row of I,
// i_eff = sum_q mob[r][q] * I_q, which the kernel forms and passes as xc.
// Every product is written in the order of the Python rows
// (src/repro_torch/epi/models/metapop_seir.py), so the float32 roundings
// agree with the plain version.
#pragma once

struct MetapopSeir {
  static constexpr int N_STATE = 4;
  static constexpr int N_TRANS = 3;
  static constexpr int N_PARAMS = 4;
  static constexpr int N_OBS = 2;
  static constexpr int N_COUPLED = 1;
  // Tables as constexpr functions, as in siard.cuh. observed compartments (I, R)
  __host__ __device__ static constexpr int observed(int m) {
    constexpr int t[N_OBS] = {2, 3};
    return t[m];
  }
  __host__ __device__ static constexpr int src(int k) {
    constexpr int t[N_TRANS] = {0, 1, 2};
    return t[k];
  }
  __host__ __device__ static constexpr int dst(int k) {
    constexpr int t[N_TRANS] = {1, 2, 3};
    return t[k];
  }
  // the coupled compartments, in the order of the spec's `coupled`: I
  __host__ __device__ static constexpr int coupled(int c) {
    constexpr int t[N_COUPLED] = {2};
    return t[c];
  }

  // E0 = kappa * A0, I0 = A0, R0 from the dataset, S = P - (E0 + A0 + R0);
  // the rows' zeros are 0 * kappa (NaN where kappa is).
  __device__ __forceinline__ static void initial(const float* p, float pop, float a0,
                                                 float r0, float /*d0*/, float* x) {
    const float e0 = p[3] * a0;
    const float zeros = 0.0f * p[3];
    x[0] = pop - (e0 + a0 + r0);
    x[1] = e0;
    x[2] = zeros + a0;
    x[3] = zeros + r0;
  }

  // before the clamp at zero; xc[0] is the coupled row of I
  __device__ __forceinline__ static void hazards(const float* x, const float* xc,
                                                 const float* p, float pop, float* h) {
    h[0] = p[0] * x[0] * xc[0] / pop;  // S -> E
    h[1] = p[1] * x[1];                // E -> I
    h[2] = p[2] * x[2];                // I -> R
  }
};
