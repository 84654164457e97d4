// Fused ABC simulation kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel, launched
// by abc_sim_distance_kernel at :322, packed by kernels/ops.py:142), with
// the counter-hash RNG of src/repro/kernels/rng.py:32-79 inlined.
//
// Each sample runs a whole-horizon Gaussian tau-leap of a compartmental
// model and a running summary distance against the observed series, and
// writes one float. One thread owns one sample, on the global index
// blockIdx.x * blockDim.x + threadIdx.x: its parameters, state, summary
// carries (cum and bin per channel) and accumulator stay in registers for
// all T days. The observed summary [n_chan, T] is staged once per block in
// shared memory.
//
// Two entries share one kernel template, told apart by where theta comes
// from (bit WAVE of the variant):
//   abc_sim_distance_<model>  theta in, structure of arrays [P, B], so
//                             neighbouring threads read neighbouring words
//                             (repro's interface, the pins, ops.abc_sim_distance);
//   abc_sim_wave_<model>      the ABC wave: each thread draws its own theta
//                             from the uniform box, keeps it in registers,
//                             writes it once row-major [B, P] (two 16-byte
//                             stores a sample for P = 8) and writes its
//                             distance with NaN turned to +inf.
// The wave entry is one launch where the prior draw took about 58 small
// launches of int64 elementwise work; theta_j is lows[j] + u * (highs[j] -
// lows[j]) with u = uniform_open(prior_seed, b, j), each operation rounded
// once, in the order of UniformBoxPrior.sample, so theta is bitwise that of
// the host draw.
//
// What bounds it on the card is instruction issue: 659 SASS instructions a
// sample-day for SIARD on the identity summary (counted from cuobjdump -sass
// by kernels/sass.py; chip_smoke.py prints the census and the issue floor
// at 4 warp-instructions a clock an SM), against 36 bytes a sample. The
// precise logf, cosf, sqrtf, powf and IEEE divisions keep the bitwise
// agreement with the plain PyTorch version and are most of them, so the
// design removes what is not arithmetic of the model: the summary selectors
// are template parameters (no per-day tests, no log1pf where it is not
// asked for), the bin flush is a countdown instead of a per-day integer
// division, the per-sample part of the hash (seed ^ idx * P1 ^ X1) and the
// per-day counter word are hoisted, and the Box-Muller normals go through
// the fast paths of logf, sqrtf and cosf without their guards, which no
// uniform the hash gives can take (rng.cuh; checked on all 2^24 of them),
// so the five normals of a day are one basic block.
//
// Variants (bits of the template's int, one kernel each, chosen on the
// host so one build serves every flat (summary, distance) pair; bin_days,
// the weights and the mean scale stay run-time values):
//   CUM   1  cumulative summary ("cumulative")
//   LOG1P 2  log1p of the bin ("log_daily", "log_weekly")
//   L1    4  |residual| and no root ("mae"); else squared residual and a
//            final sqrt ("euclidean", "normalized_euclidean")
//   WAVE  8  the wave entry
// lower_summary gives (CUM, LOG1P) in {00, 10, 01} for the registered
// summaries and 11 for a SummarySpec with both set; with L1 and WAVE that
// is all 16 combinations, each instantiated.
//
// Distances depend on the global index only, so they are bitwise the same
// for every block size. Build with --fmad=false, so that h + sqrt(h) * z,
// the accumulator update and low + u * width round as the plain PyTorch
// version does.

#include <array>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "rng.cuh"
#include "siard.cuh"

namespace {

constexpr int MAX_CHAN = 8;
constexpr int MAX_BLOCK = 256;
// host-side constant layout, read by pack_consts in kernels/abc_sim.py
constexpr int F_POP = 0, F_A0 = 1, F_R0 = 2, F_D0 = 3, F_MEAN_SCALE = 4, F_WEIGHTS = 5;
constexpr int N_FCONST = F_WEIGHTS + MAX_CHAN;
constexpr int I_SEED = 0, I_CUMULATIVE = 1, I_LOG1P = 2, I_POWER = 3, I_ROOT = 4,
              I_BIN_DAYS = 5;
constexpr int N_ICONST = 6;
constexpr int CUM = 1, LOG1P = 2, L1 = 4, WAVE = 8, N_VARIANTS = 16;

struct Consts {
  float pop, a0, r0, d0, mean_scale;
  float weights[MAX_CHAN];
  uint32_t seed;
  int bin_days;
};

// The uniform box and the prior seed of the wave entry.
template <int P>
struct Box {
  float lo[P], hi[P];
  uint32_t seed;
};

// One sample of variant V: its parameters, state, summary carries and
// accumulator, all in registers, and one day of the tau-leap and of the
// running summary distance given that day's normals.
template <class Model, int V>
struct Sample {
  float p[Model::N_PARAMS], x[Model::N_STATE], cum[Model::N_OBS], bin[Model::N_OBS];
  float acc;
  int next_flush;  // the day that closes the current bin: (day + 1) % bin_days == 0

  // theta from the box (wave entry; written once, row-major, to theta_out)
  // or read from theta_in [P, B]
  __device__ __forceinline__ void load_theta(const float* __restrict__ theta_in,
                                             float* __restrict__ theta_out, int b, int B,
                                             const Box<Model::N_PARAMS>& box) {
    constexpr int P = Model::N_PARAMS;
    if constexpr ((V & WAVE) != 0) {
      float* row = theta_out + static_cast<size_t>(b) * P;
      const uint32_t base = rng::sample_base(box.seed, static_cast<uint32_t>(b));
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float u = rng::unit_open(rng::hash_from(base, static_cast<uint32_t>(j) * rng::P2));
        p[j] = box.lo[j] + u * (box.hi[j] - box.lo[j]);
      }
      if constexpr (P % 4 == 0) {
#pragma unroll
        for (int j = 0; j < P; j += 4)
          *reinterpret_cast<float4*>(row + j) = make_float4(p[j], p[j + 1], p[j + 2], p[j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) row[j] = p[j];
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) p[k] = theta_in[static_cast<size_t>(k) * B + b];
    }
  }

  __device__ __forceinline__ void start(const Consts& c) {
    Model::initial(p, c.pop, c.a0, c.r0, c.d0, x);
#pragma unroll
    for (int m = 0; m < Model::N_OBS; ++m) cum[m] = bin[m] = 0.0f;
    acc = 0.0f;
    next_flush = c.bin_days - 1;
  }

  __device__ __forceinline__ void day(const float (&z)[Model::N_TRANS],
                                      const float* __restrict__ obs_s, int day, int T,
                                      const Consts& c) {
    // hazards, clamped at zero (NaN passes through, as jnp.maximum does)
    float n[Model::N_TRANS];
    Model::hazards(x, p, c.pop, n);
#pragma unroll
    for (int k = 0; k < Model::N_TRANS; ++k) {
      const float h = n[k] < 0.0f ? 0.0f : n[k];
      n[k] = floorf(h + sqrtf(h) * z[k]);
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
    const bool closes = day == next_flush;
    next_flush += closes ? c.bin_days : 0;
    const float flush = (closes || day == T - 1) ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 0; m < Model::N_OBS; ++m) {
      const float xm = x[Model::observed(m)];
      float bv;
      if constexpr ((V & CUM) != 0) {
        cum[m] = cum[m] + xm;
        bv = cum[m];
      } else {
        bv = bin[m] + xm;
      }
      float s = bv;
      if constexpr ((V & LOG1P) != 0) s = log1pf(bv < 0.0f ? 0.0f : bv);
      const float diff = s - obs_s[m * T + day];
      const float term = (V & L1) != 0 ? fabsf(diff) : diff * diff;
      acc = acc + flush * (c.weights[m] * term);
      bin[m] = bv * (1.0f - flush);
    }
  }

  __device__ __forceinline__ float distance(const Consts& c) const {
    const float a = acc * c.mean_scale;
    const float d = (V & L1) != 0 ? a : sqrtf(a);
    if constexpr ((V & WAVE) != 0) return isnan(d) ? __int_as_float(0x7f800000) : d;
    return d;
  }
};

template <class Model, int V>
__global__ void __launch_bounds__(MAX_BLOCK)
    abc_sim_kernel(const float* __restrict__ theta_in,  // [P, B] (theta-in entry)
                   const float* __restrict__ obs,       // [n_chan, T]
                   float* __restrict__ theta_out,       // [B, P] (wave entry)
                   float* __restrict__ out,             // [B]
                   int B, int T, Consts c, Box<Model::N_PARAMS> box) {
  static_assert(Model::N_OBS <= MAX_CHAN, "too many summary channels");
  extern __shared__ float obs_s[];
  for (int i = threadIdx.x; i < Model::N_OBS * T; i += blockDim.x) obs_s[i] = obs[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sample<Model, V> s;
  s.load_theta(theta_in, theta_out, b, B, box);
  s.start(c);
  const uint32_t base = rng::sample_base(c.seed, static_cast<uint32_t>(b));
  uint32_t day_p2 = 0u;  // day * DAY_P2
  for (int day = 0; day < T; ++day, day_p2 += rng::DAY_P2) {
    float z[Model::N_TRANS];
    rng::day_normals<Model::N_TRANS>(base, day_p2, z);
    s.day(z, obs_s, day, T, c);
  }
  out[b] = s.distance(c);
}

// One kernel per variant, indexed by the variant's bits.
template <class Model, int... V>
auto kernel_table(std::integer_sequence<int, V...>) {
  using Fn = void (*)(const float*, const float*, float*, float*, int, int, Consts,
                      Box<Model::N_PARAMS>);
  return std::array<Fn, sizeof...(V)>{&abc_sim_kernel<Model, V>...};
}

template <class Model>
int launch_abc_sim(const void* theta_in, const void* obs, void* theta_out, void* out,
                   const float* fconst, const int* iconst, const Box<Model::N_PARAMS>& box,
                   bool wave, int B, int T, int block, void* stream) {
  if (B <= 0 || T <= 0 || block <= 0 || block > MAX_BLOCK) return cudaErrorInvalidValue;
  Consts c;
  c.pop = fconst[F_POP];
  c.a0 = fconst[F_A0];
  c.r0 = fconst[F_R0];
  c.d0 = fconst[F_D0];
  c.mean_scale = fconst[F_MEAN_SCALE];
  for (int m = 0; m < MAX_CHAN; ++m) c.weights[m] = fconst[F_WEIGHTS + m];
  c.seed = static_cast<uint32_t>(iconst[I_SEED]);
  c.bin_days = iconst[I_BIN_DAYS];
  if (c.bin_days < 1) return cudaErrorInvalidValue;
  // (power, root) is (2, 1) or (1, 0): the two distance families
  const int power = iconst[I_POWER], root = iconst[I_ROOT];
  if (!((power == 2 && root == 1) || (power == 1 && root == 0))) return cudaErrorInvalidValue;
  const int variant = (iconst[I_CUMULATIVE] == 1 ? CUM : 0) | (iconst[I_LOG1P] == 1 ? LOG1P : 0) |
                      (power == 1 ? L1 : 0) | (wave ? WAVE : 0);
  static const auto table = kernel_table<Model>(std::make_integer_sequence<int, N_VARIANTS>{});
  const auto kernel = table[variant];

  const size_t smem = sizeof(float) * Model::N_OBS * static_cast<size_t>(T);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + block - 1) / block;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta_in), static_cast<const float*>(obs),
      static_cast<float*>(theta_out), static_cast<float*>(out), B, T, c, box);
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

// Every u = k * 2^-24, k = 1..2^24, through the branch-free Box-Muller
// pieces and through logf, sqrtf and cosf: counts[0] the u whose
// sqrt(-2 log u) differ in any bit, counts[1] those whose cos(2 pi u) do.
__global__ void unit_math_kernel(unsigned int* counts) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (1u << 24)) return;
  const float u = static_cast<float>(k + 1u) * rng::INV_2_24;
  const float r_fast = rng::sqrt_unit(-2.0f * rng::log_unit(u));
  const float r_libm = sqrtf(-2.0f * logf(u));
  const float c_fast = rng::cos_unit(rng::TWO_PI * u);
  const float c_libm = cosf(rng::TWO_PI * u);
  if (__float_as_uint(r_fast) != __float_as_uint(r_libm)) atomicAdd(&counts[0], 1u);
  if (__float_as_uint(c_fast) != __float_as_uint(c_libm)) atomicAdd(&counts[1], 1u);
}

}  // namespace

extern "C" {

// Layout sizes of the host constant arrays, so the Python side can check them.
int abc_sim_n_fconst() { return N_FCONST; }
int abc_sim_n_iconst() { return N_ICONST; }
int abc_sim_max_chan() { return MAX_CHAN; }
int abc_sim_max_block() { return MAX_BLOCK; }

// theta [P, B] f32, obs [n_chan, T] f32 and out [B] f32 are device pointers;
// fconst [N_FCONST] and iconst [N_ICONST] are host arrays copied into the
// kernel's parameters. Returns cudaGetLastError() after the launch.
int abc_sim_distance_siard(const void* theta, const void* obs, void* out, const void* fconst,
                           const void* iconst, int B, int T, int block, void* stream) {
  return launch_abc_sim<Siard>(theta, obs, nullptr, out, static_cast<const float*>(fconst),
                               static_cast<const int*>(iconst), Box<Siard::N_PARAMS>{}, false,
                               B, T, block, stream);
}

// The ABC wave: theta [B, P] f32 (16-byte aligned) and dist [B] f32 are
// device outputs; lows and highs [P] are host arrays and, with prior_seed,
// go into the kernel's parameters; iconst's seed word is the simulation
// seed.
int abc_sim_wave_siard(unsigned int prior_seed, const void* lows, const void* highs,
                       const void* obs, void* theta, void* dist, const void* fconst,
                       const void* iconst, int B, int T, int block, void* stream) {
  Box<Siard::N_PARAMS> box;
  for (int j = 0; j < Siard::N_PARAMS; ++j) {
    box.lo[j] = static_cast<const float*>(lows)[j];
    box.hi[j] = static_cast<const float*>(highs)[j];
  }
  box.seed = prior_seed;
  return launch_abc_sim<Siard>(nullptr, obs, theta, dist, static_cast<const float*>(fconst),
                               static_cast<const int*>(iconst), box, true, B, T, block, stream);
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

// counts: device uint32 [2], zeroed by the caller (see unit_math_kernel)
int unit_math_mismatches(void* counts, void* stream) {
  unit_math_kernel<<<(1u << 24) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(counts));
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
