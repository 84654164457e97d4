// Fused ABC simulation kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel, launched
// by abc_sim_distance_kernel at :322, packed by kernels/ops.py:142), with
// the counter-hash RNG of src/repro/kernels/rng.py:32-79 inlined.
//
// Each sample runs a whole-horizon Gaussian tau-leap of a compartmental
// model and a running summary distance against the observed series, and
// writes one float. One thread owns one sample, on the global index
// blockIdx.x * blockDim.x + threadIdx.x: its state, its summary carries
// (cum and bin per channel) and its accumulator stay in registers for all
// T days, so device memory sees theta in (structure of arrays [P, B], so
// neighbouring threads read neighbouring addresses) and one float out:
// 36 bytes a sample for SIARD. The observed summary [n_chan, T] is staged
// once per block in shared memory.
//
// What bounds it on the card is arithmetic: about 330 operations a
// sample-day for SIARD (hash, Box-Muller, hazards, clamp, summary; counted
// in kernels/abc_sim.py ops_per_sample_day) against 36 bytes a sample,
// several hundred operations per byte at 49 days. The design keeps the work
// where the arithmetic units are and out of device memory.
//
// The summary selectors, weights and mean scale are runtime values, as in
// the TPU kernel, so one build serves every flat (summary, distance) pair.
// Distances depend on the global index only, so they are bitwise the same
// for every block size. Build with --fmad=false, so that h + sqrt(h) * z
// and the accumulator update round as the plain PyTorch version does.

#include <cstdint>
#include <cuda_runtime.h>

#include "rng.cuh"
#include "siard.cuh"

namespace {

constexpr int MAX_CHAN = 8;
// host-side constant layout, read by pack_consts in kernels/abc_sim.py
constexpr int F_POP = 0, F_A0 = 1, F_R0 = 2, F_D0 = 3, F_MEAN_SCALE = 4, F_WEIGHTS = 5;
constexpr int N_FCONST = F_WEIGHTS + MAX_CHAN;
constexpr int I_SEED = 0, I_CUMULATIVE = 1, I_LOG1P = 2, I_POWER = 3, I_ROOT = 4,
              I_BIN_DAYS = 5;
constexpr int N_ICONST = 6;

struct Consts {
  float pop, a0, r0, d0, mean_scale;
  float weights[MAX_CHAN];
  uint32_t seed;
  int cumulative, log1p, power, root, bin_days;
};

template <class Model>
__global__ void abc_sim_distance_kernel(const float* __restrict__ theta,  // [P, B]
                                        const float* __restrict__ obs,    // [n_chan, T]
                                        float* __restrict__ out,          // [B]
                                        int B, int T, Consts c) {
  static_assert(Model::N_OBS <= MAX_CHAN, "too many summary channels");
  extern __shared__ float obs_s[];
  for (int i = threadIdx.x; i < Model::N_OBS * T; i += blockDim.x) obs_s[i] = obs[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t idx = static_cast<uint32_t>(b);

  float p[Model::N_PARAMS];
#pragma unroll
  for (int k = 0; k < Model::N_PARAMS; ++k) p[k] = theta[static_cast<size_t>(k) * B + b];

  float x[Model::N_STATE];
  Model::initial(p, c.pop, c.a0, c.r0, c.d0, x);
  float cum[Model::N_OBS], bin[Model::N_OBS];
#pragma unroll
  for (int m = 0; m < Model::N_OBS; ++m) cum[m] = bin[m] = 0.0f;
  float acc = 0.0f;

  for (int day = 0; day < T; ++day) {
    // hazards, clamped at zero (NaN passes through, as jnp.maximum does)
    float n[Model::N_TRANS];
    Model::hazards(x, p, c.pop, n);
#pragma unroll
    for (int k = 0; k < Model::N_TRANS; ++k) {
      const float h = n[k] < 0.0f ? 0.0f : n[k];
      const float z = rng::normal(c.seed, idx, rng::day_transition_ctr(day, k));
      n[k] = floorf(h + sqrtf(h) * z);
    }
    // sequential source draining in declaration order, then stoichiometry
    float rem[Model::N_STATE];
#pragma unroll
    for (int j = 0; j < Model::N_STATE; ++j) rem[j] = x[j];
#pragma unroll
    for (int k = 0; k < Model::N_TRANS; ++k) {
      const float avail = rem[Model::src(k)];
      float t = n[k] < 0.0f ? 0.0f : n[k];
      t = t > avail ? avail : t;
      rem[Model::src(k)] = avail - t;
      n[k] = t;
    }
#pragma unroll
    for (int k = 0; k < Model::N_TRANS; ++k) {
      x[Model::src(k)] -= n[k];
      x[Model::dst(k)] += n[k];
    }
    // running summary distance, channel by channel
    const float flush = ((day + 1) % c.bin_days == 0 || day == T - 1) ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 0; m < Model::N_OBS; ++m) {
      const float xm = x[Model::observed(m)];
      const float cm = cum[m] + xm;
      const float v = c.cumulative == 1 ? cm : xm;
      const float bv = c.cumulative == 1 ? v : bin[m] + v;
      const float s = c.log1p == 1 ? log1pf(bv < 0.0f ? 0.0f : bv) : bv;
      const float diff = s - obs_s[m * T + day];
      const float term = c.power == 1 ? fabsf(diff) : diff * diff;
      acc = acc + flush * (c.weights[m] * term);
      cum[m] = cm;
      bin[m] = bv * (1.0f - flush);
    }
  }
  acc = acc * c.mean_scale;
  out[b] = c.root == 1 ? sqrtf(acc) : acc;
}

template <class Model>
int launch_abc_sim(const void* theta, const void* obs, void* out, const float* fconst,
                   const int* iconst, int B, int T, int block, void* stream) {
  if (B <= 0 || T <= 0 || block <= 0 || block > 1024) return cudaErrorInvalidValue;
  Consts c;
  c.pop = fconst[F_POP];
  c.a0 = fconst[F_A0];
  c.r0 = fconst[F_R0];
  c.d0 = fconst[F_D0];
  c.mean_scale = fconst[F_MEAN_SCALE];
  for (int m = 0; m < MAX_CHAN; ++m) c.weights[m] = fconst[F_WEIGHTS + m];
  c.seed = static_cast<uint32_t>(iconst[I_SEED]);
  c.cumulative = iconst[I_CUMULATIVE];
  c.log1p = iconst[I_LOG1P];
  c.power = iconst[I_POWER];
  c.root = iconst[I_ROOT];
  c.bin_days = iconst[I_BIN_DAYS];
  if (c.bin_days < 1) return cudaErrorInvalidValue;

  const size_t smem = sizeof(float) * Model::N_OBS * static_cast<size_t>(T);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(abc_sim_distance_kernel<Model>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + block - 1) / block;
  abc_sim_distance_kernel<Model><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(obs),
      static_cast<float*>(out), B, T, c);
  return cudaGetLastError();
}

// hash bits (bits != 0) or normals of counters 0..n_ctr-1 for samples 0..B-1
__global__ void rng_normals_kernel(uint32_t seed, int B, int n_ctr, int bits, void* out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * n_ctr) return;
  const uint32_t b = static_cast<uint32_t>(i / n_ctr);
  const uint32_t ctr = static_cast<uint32_t>(i % n_ctr);
  if (bits) {
    static_cast<uint32_t*>(out)[i] = rng::hash_u32(seed, b, ctr);
  } else {
    static_cast<float*>(out)[i] = rng::normal(seed, b, ctr);
  }
}

}  // namespace

extern "C" {

// Layout sizes of the host constant arrays, so the Python side can check them.
int abc_sim_n_fconst() { return N_FCONST; }
int abc_sim_n_iconst() { return N_ICONST; }
int abc_sim_max_chan() { return MAX_CHAN; }

// theta [P, B] f32, obs [n_chan, T] f32 and out [B] f32 are device pointers;
// fconst [N_FCONST] and iconst [N_ICONST] are host arrays copied into the
// kernel's parameters. Returns cudaGetLastError() after the launch.
int abc_sim_distance_siard(const void* theta, const void* obs, void* out, const void* fconst,
                           const void* iconst, int B, int T, int block, void* stream) {
  return launch_abc_sim<Siard>(theta, obs, out, static_cast<const float*>(fconst),
                               static_cast<const int*>(iconst), B, T, block, stream);
}

// out is [B, n_ctr]: uint32 hash bits when bits != 0, else float32 normals.
int rng_normals(unsigned int seed, int B, int n_ctr, int bits, void* out, int block,
                void* stream) {
  if (B <= 0 || n_ctr <= 0 || block <= 0 || block > 1024) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * n_ctr;
  const long long grid = (n + block - 1) / block;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  rng_normals_kernel<<<static_cast<unsigned int>(grid), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(seed, B, n_ctr, bits, out);
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
