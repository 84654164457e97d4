// Fused ABC simulation kernel for Hopper (sm_90a): the template every
// model's translation unit instantiates (abc_sim_<model>.cu; SIARD's also
// holds the RNG test entries).
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel, launched
// by abc_sim_distance_kernel at :322, packed by kernels/ops.py:142): its flat
// model rows (:261-266) and its schedule path (`sched`, :133, :176-180,
// :248), with the counter-hash RNG of src/repro/kernels/rng.py:32-79
// inlined.
//
// Each sample runs a whole-horizon Gaussian tau-leap of a compartmental
// model and a running summary distance against the observed series, and
// writes one float. One thread owns one sample, on the global index
// blockIdx.x * blockDim.x + threadIdx.x: its parameters, state, summary
// carries (cum and bin per channel) and accumulator stay in registers for
// all T days. The observed summary [n_chan, T] is staged once per block in
// shared memory. A model is a struct (siard.cuh, sir.cuh, seir.cuh,
// seiard.cuh) with its sizes, its stoichiometry as source and destination
// tables, its seeding and its hazards; the template does not change.
//
// Two entries share one kernel template, told apart by where theta comes
// from (bit WAVE of the variant):
//   abc_sim_distance_<model>  theta in, structure of arrays [W, B], so
//                             neighbouring threads read neighbouring words
//                             (repro's interface, the pins, ops.abc_sim_distance);
//   abc_sim_wave_<model>      the ABC wave: each thread draws its own theta
//                             from the uniform box, keeps its P parameters in
//                             registers, writes all W columns once row-major
//                             [B, W] (16-byte stores where W and P are
//                             multiples of 4) and writes its distance with NaN
//                             turned to +inf.
// W = P + S, the model's P parameters and an intervention schedule's S
// scale columns (S = 0 without one). theta_j is lows[j] + u * (highs[j] -
// lows[j]) with u = uniform_open(prior_seed, offset + b, j), each operation
// rounded once, in the order of UniformBoxPrior.sample, so theta is bitwise
// that of the host draw of the widened prior.
//
// Sample offset. A wave entry takes an `offset`: sample b of the launch
// hashes its prior draw and its noise on the index offset + b, and writes
// row b. A launch of B rows at offset o is therefore bitwise rows [o, o + B)
// of the offset-0 launch of o + B rows, which is how a rank of a pjit-style
// run draws its slice of one logical wave (core/distributed.py). The
// theta-in entries hash on b (offset 0).
//
// Intervention schedules. The breakpoints, the scales and the schedule's
// shape (windows, scaled parameters) are run-time values in the kernel's
// parameters (`Sched`), as the breakpoints were run-time lanes on the TPU,
// so a lockdown-day sweep and every schedule shape reuse one build. The day
// loop runs as segments between breakpoints: window w covers days
// [bp[w-1], bp[w]). At the start of window w >= 1 each scaled parameter
// becomes base * scale, one rounding, repro's product; the others keep
// their base value. The base and the scale are read from this sample's
// theta (theta_in, or the row the wave entry wrote), so no register holds
// them through the days, and nothing is added to a day's instructions:
// without a schedule the loop is one segment of T days.
//
// What bounds it on the card is instruction issue: 660 SASS instructions a
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
// so the normals of a day are one basic block.
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
// is all 16 combinations, each instantiated for each model.
//
// Distances depend on the global index only, so they are bitwise the same
// for every block size. Build with --fmad=false, so that h + sqrt(h) * z,
// the accumulator update, base * scale and low + u * width round as the
// plain PyTorch version does.
#pragma once

#include <array>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int MAX_CHAN = 8;
constexpr int MAX_BLOCK = 256;
constexpr int MAX_WINDOWS = 16;
constexpr int MAX_PARAMS = 16;
// host-side constant layout, read by pack_consts in kernels/abc_sim.py
constexpr int F_POP = 0, F_A0 = 1, F_R0 = 2, F_D0 = 3, F_MEAN_SCALE = 4, F_WEIGHTS = 5;
constexpr int N_FCONST = F_WEIGHTS + MAX_CHAN;
// iconst: the seed, the summary flags, then the schedule: its window count,
// its scaled-parameter count, MAX_WINDOWS breakpoint days and, for each of
// MAX_PARAMS parameters, its place among the scaled ones or -1
constexpr int I_SEED = 0, I_CUMULATIVE = 1, I_LOG1P = 2, I_POWER = 3, I_ROOT = 4,
              I_BIN_DAYS = 5, I_N_WINDOWS = 6, I_N_TV = 7, I_BREAKPOINTS = 8,
              I_TV_SLOT = I_BREAKPOINTS + MAX_WINDOWS;
constexpr int N_ICONST = I_TV_SLOT + MAX_PARAMS;
constexpr int CUM = 1, LOG1P = 2, L1 = 4, WAVE = 8, N_VARIANTS = 16;

struct Consts {
  float pop, a0, r0, d0, mean_scale;
  float weights[MAX_CHAN];
  uint32_t seed;
  uint32_t offset;  // the hash index of the launch's sample 0
  int bin_days;
};

// The uniform box and the prior seed of the wave entry: P parameters and at
// most MAX_WINDOWS scales of each.
template <int P>
struct Box {
  static constexpr int MAX_COLS = P * (1 + MAX_WINDOWS);
  float lo[MAX_COLS], hi[MAX_COLS];
  uint32_t seed;
};

// An intervention schedule: window w + 1 starts on day bp[w]; parameter j
// is scaled when slot[j] >= 0, by theta column P + (w - 1) * n_tv + slot[j]
// in window w >= 1. n_windows == 0: no schedule.
template <int P>
struct Sched {
  int n_windows, n_tv;
  int bp[MAX_WINDOWS];
  int slot[P];

  __host__ __device__ int width() const { return P + n_windows * n_tv; }
};

// One sample of variant V: its parameters, state, summary carries and
// accumulator, all in registers, and one day of the tau-leap and of the
// running summary distance given that day's normals.
template <class Model, int V>
struct Sample {
  float p[Model::N_PARAMS], x[Model::N_STATE], cum[Model::N_OBS], bin[Model::N_OBS];
  float acc;
  int next_flush;  // the day that closes the current bin: (day + 1) % bin_days == 0

  // theta from the box (wave entry; all W columns written once, row-major,
  // to row b of theta_out, drawn on hash index idx) or read from theta_in
  // [W, B]; p holds the P base values
  __device__ __forceinline__ void load_theta(const float* __restrict__ theta_in,
                                             float* __restrict__ theta_out, int b,
                                             uint32_t idx, int B,
                                             const Box<Model::N_PARAMS>& box,
                                             int W = Model::N_PARAMS) {
    constexpr int P = Model::N_PARAMS;
    if constexpr ((V & WAVE) != 0) {
      float* row = theta_out + static_cast<size_t>(b) * W;
      const uint32_t base = rng::sample_base(box.seed, idx);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float u = rng::unit_open(rng::hash_from(base, static_cast<uint32_t>(j) * rng::P2));
        p[j] = box.lo[j] + u * (box.hi[j] - box.lo[j]);
      }
      bool stored = false;
      if constexpr (P % 4 == 0) {
        if (W % 4 == 0) {
#pragma unroll
          for (int j = 0; j < P; j += 4)
            *reinterpret_cast<float4*>(row + j) = make_float4(p[j], p[j + 1], p[j + 2], p[j + 3]);
          stored = true;
        }
      }
      if (!stored) {
#pragma unroll
        for (int j = 0; j < P; ++j) row[j] = p[j];
      }
      // the schedule's scale columns, counters P..W-1 of the same stream
      for (int j = P; j < W; ++j) {
        const float u = rng::unit_open(rng::hash_from(base, static_cast<uint32_t>(j) * rng::P2));
        row[j] = box.lo[j] + u * (box.hi[j] - box.lo[j]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) p[k] = theta_in[static_cast<size_t>(k) * B + b];
    }
  }

  // The parameters of window w >= 1: base * scale for each scaled parameter,
  // from this sample's theta at `col` (column j at col[j * stride]).
  __device__ __forceinline__ void enter_window(int w, const Sched<Model::N_PARAMS>& sched,
                                               const float* col, size_t stride) {
    constexpr int P = Model::N_PARAMS;
    const int first = P + (w - 1) * sched.n_tv;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = sched.slot[j];
      if (s >= 0) p[j] = col[j * stride] * col[(first + s) * stride];
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

// Box and Sched are __grid_constant__: the kernel indexes them with run-time
// indices (a window's breakpoint, a scale column's bounds) straight from the
// parameter space, without a copy to local memory.
template <class Model, int V>
__global__ void __launch_bounds__(MAX_BLOCK)
    abc_sim_kernel(const float* __restrict__ theta_in,  // [W, B] (theta-in entry)
                   const float* __restrict__ obs,       // [n_chan, T]
                   float* __restrict__ theta_out,       // [B, W] (wave entry)
                   float* __restrict__ out,             // [B]
                   int B, int T, Consts c, const __grid_constant__ Box<Model::N_PARAMS> box,
                   const __grid_constant__ Sched<Model::N_PARAMS> sched,
                   const int* __restrict__ gate) {  // null, or 0: the block writes nothing
  static_assert(Model::N_OBS <= MAX_CHAN, "too many summary channels");
  static_assert(Model::N_PARAMS <= MAX_PARAMS, "too many parameters");
  if (gate != nullptr && *gate == 0) return;  // the same in every thread
  extern __shared__ float obs_s[];
  for (int i = threadIdx.x; i < Model::N_OBS * T; i += blockDim.x) obs_s[i] = obs[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = sched.width();
  const uint32_t idx = c.offset + static_cast<uint32_t>(b);  // the sample's hash index
  Sample<Model, V> s;
  s.load_theta(theta_in, theta_out, b, idx, B, box, W);
  s.start(c);
  // this sample's theta: a column of theta_in, or the row just written
  const bool wave = (V & WAVE) != 0;
  const float* col = wave ? theta_out + static_cast<size_t>(b) * W : theta_in + b;
  const size_t stride = wave ? 1 : static_cast<size_t>(B);
  const uint32_t base = rng::sample_base(c.seed, idx);
  uint32_t day_p2 = 0u;  // day * DAY_P2
  int day = 0;
  for (int w = 0;; ++w) {
    const int end = w < sched.n_windows ? min(sched.bp[w], T) : T;
    for (; day < end; ++day, day_p2 += rng::DAY_P2) {
      float z[Model::N_TRANS];
      rng::day_normals<Model::N_TRANS>(base, day_p2, z);
      s.day(z, obs_s, day, T, c);
    }
    if (day >= T) break;
    s.enter_window(w + 1, sched, col, stride);
  }
  out[b] = s.distance(c);
}

// One kernel per variant, indexed by the variant's bits.
template <class Model, int... V>
auto kernel_table(std::integer_sequence<int, V...>) {
  using Fn = void (*)(const float*, const float*, float*, float*, int, int, Consts,
                      Box<Model::N_PARAMS>, Sched<Model::N_PARAMS>, const int*);
  return std::array<Fn, sizeof...(V)>{&abc_sim_kernel<Model, V>...};
}

// Whether the hash indices offset .. offset + B - 1 all fit in 32 bits.
inline bool index_range_ok(uint32_t offset, int B) {
  return static_cast<uint64_t>(offset) + static_cast<uint64_t>(B) <= (uint64_t{1} << 32);
}

// The schedule lanes of iconst, checked: 0 windows and no scaled parameter,
// or 1..MAX_WINDOWS strictly increasing positive breakpoints and n_tv >= 1
// parameters, each in one slot 0..n_tv-1.
template <int P>
bool read_sched(const int* iconst, Sched<P>& s) {
  s.n_windows = iconst[I_N_WINDOWS];
  s.n_tv = iconst[I_N_TV];
  if (s.n_windows < 0 || s.n_windows > MAX_WINDOWS || s.n_tv < 0 || s.n_tv > P) return false;
  if ((s.n_windows == 0) != (s.n_tv == 0)) return false;
  for (int w = 0; w < MAX_WINDOWS; ++w) s.bp[w] = iconst[I_BREAKPOINTS + w];
  for (int w = 0; w < s.n_windows; ++w)
    if (s.bp[w] <= (w ? s.bp[w - 1] : 0)) return false;
  int seen = 0;
  for (int j = 0; j < P; ++j) {
    s.slot[j] = iconst[I_TV_SLOT + j];
    if (s.slot[j] < -1 || s.slot[j] >= s.n_tv) return false;
    if (s.slot[j] >= 0) {
      if (seen & (1 << s.slot[j])) return false;
      seen |= 1 << s.slot[j];
    }
  }
  return seen == (1 << s.n_tv) - 1;
}

template <class Model>
int launch_abc_sim(const void* theta_in, const void* obs, void* theta_out, void* out,
                   const float* fconst, const int* iconst, const float* lows,
                   const float* highs, uint32_t prior_seed, bool wave, int B, int T, int block,
                   void* stream, const int* gate, uint32_t offset = 0u) {
  constexpr int P = Model::N_PARAMS;
  if (B <= 0 || T <= 0 || block <= 0 || block > MAX_BLOCK) return cudaErrorInvalidValue;
  if (!index_range_ok(offset, B)) return cudaErrorInvalidValue;
  Consts c;
  c.pop = fconst[F_POP];
  c.a0 = fconst[F_A0];
  c.r0 = fconst[F_R0];
  c.d0 = fconst[F_D0];
  c.mean_scale = fconst[F_MEAN_SCALE];
  for (int m = 0; m < MAX_CHAN; ++m) c.weights[m] = fconst[F_WEIGHTS + m];
  c.seed = static_cast<uint32_t>(iconst[I_SEED]);
  c.offset = offset;
  c.bin_days = iconst[I_BIN_DAYS];
  if (c.bin_days < 1) return cudaErrorInvalidValue;
  // (power, root) is (2, 1) or (1, 0): the two distance families
  const int power = iconst[I_POWER], root = iconst[I_ROOT];
  if (!((power == 2 && root == 1) || (power == 1 && root == 0))) return cudaErrorInvalidValue;
  Sched<P> sched;
  if (!read_sched(iconst, sched)) return cudaErrorInvalidValue;
  Box<P> box{};
  if (wave) {
    for (int j = 0; j < sched.width(); ++j) {
      box.lo[j] = lows[j];
      box.hi[j] = highs[j];
    }
    box.seed = prior_seed;
  }
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
      static_cast<float*>(theta_out), static_cast<float*>(out), B, T, c, box, sched, gate);
  return cudaGetLastError();
}

}  // namespace

// The C interface of one model's kernel: abc_sim_distance_<name> and
// abc_sim_wave_<name>, and the layout sizes the Python side checks.
//
// abc_sim_distance_<name>: theta [W, B] f32, obs [n_chan, T] f32 and out [B]
// f32 are device pointers; fconst [N_FCONST] and iconst [N_ICONST] are host
// arrays copied into the kernel's parameters (W = P + the schedule's scale
// columns, from iconst).
// abc_sim_wave_<name>: theta [B, W] f32 (16-byte aligned) and dist [B] f32
// are device outputs; lows and highs [W] are host arrays and, with
// prior_seed, go into the kernel's parameters; iconst's seed word is the
// simulation seed; sample b hashes on offset + b (cudaErrorInvalidValue
// where offset + B passes 2^32).
// Both take a gate (the theta-in entry's last argument, the wave entry's
// last but its offset), a device int or null: a launch whose gate reads 0
// when it runs writes nothing (a wave enqueued past the ABC target), null
// always runs.
// Both return cudaGetLastError() after the launch (cudaErrorInvalidValue
// for arguments the kernel does not take).
#define ABC_SIM_EXPORTS(name, Model)                                                            \
  extern "C" {                                                                                  \
  int abc_sim_n_fconst() { return N_FCONST; }                                                   \
  int abc_sim_n_iconst() { return N_ICONST; }                                                   \
  int abc_sim_max_chan() { return MAX_CHAN; }                                                   \
  int abc_sim_max_block() { return MAX_BLOCK; }                                                 \
  int abc_sim_distance_##name(const void* theta, const void* obs, void* out, const void* fconst, \
                              const void* iconst, int B, int T, int block, void* stream,       \
                              const void* gate) {                                               \
    return launch_abc_sim<Model>(theta, obs, nullptr, out, static_cast<const float*>(fconst),   \
                                 static_cast<const int*>(iconst), nullptr, nullptr, 0u, false,  \
                                 B, T, block, stream, static_cast<const int*>(gate));           \
  }                                                                                             \
  int abc_sim_wave_##name(unsigned int prior_seed, const void* lows, const void* highs,         \
                          const void* obs, void* theta, void* dist, const void* fconst,         \
                          const void* iconst, int B, int T, int block, void* stream,            \
                          const void* gate, unsigned int offset) {                              \
    return launch_abc_sim<Model>(nullptr, obs, theta, dist, static_cast<const float*>(fconst),  \
                                 static_cast<const int*>(iconst),                               \
                                 static_cast<const float*>(lows),                               \
                                 static_cast<const float*>(highs), prior_seed, true, B, T,      \
                                 block, stream, static_cast<const int*>(gate), offset);         \
  }                                                                                             \
  const char* kernel_error_string(int code) {                                                   \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                                  \
  }                                                                                             \
  }
