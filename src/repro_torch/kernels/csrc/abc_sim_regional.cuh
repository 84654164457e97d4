// The region axis of the fused ABC simulation kernel for Hopper (sm_90a):
// the template each abc_sim_regional_<struct>.cu instantiates for one
// model's struct.
//
// Replaces the region axis of the TPU kernel src/repro/kernels/abc_sim.py:138
// (_kernel): its mobility lanes (:95-119), the region geometry, pop_r and
// mob (:195-208), the per-region seeding (:220-236), the coupled rows
// (:254-260), per-region hazards and RNG slots r * T + k at ctr_slots
// (:261-276), the per-region drain (:280) and the region pooling (:287-294).
//
// This is the route for small R (`abc_sim.regional_route`); the route for
// large R, one warp a sample, is abc_sim_regional_warp.cuh, and the route
// past MAX_REGIONS, a tile of samples a block, abc_sim_regional_tile.cuh;
// both share the checked launch arguments below (RegionalArgs, opt_in_smem).
//
// One thread owns one sample, as in the flat kernel (abc_sim.cuh, whose
// constants, parameter structs, theta draw and schedule windows this file
// uses unchanged). R and the mobility matrix are run-time values: one build
// serves every R up to MAX_REGIONS and every matrix. A sample's region-major
// state [R * C], its summary carries [n_chan] each and its coupled rows
// [R * N_COUPLED] do not fit registers with a run-time R, so they live in
// the thread's local memory (cached in L1); a region's C state values are
// moved into registers for its day. The block stages the observed summary
// [n_chan, T], the channel weights [n_chan] and, for a coupled model, the
// mobility matrix [R, R] (40 KB at R = 100) in shared memory; every thread of
// a warp reads the same mobility word, a broadcast.
//
// A day, in the TPU kernel body's order, so that the plain version
// (kernels/ref.py) agrees bitwise:
//   1. the coupled rows of every region from the start-of-day state:
//      mob[r][0] * x_0 + mob[r][1] * x_1 + ..., left to right from the first
//      product;
//   2. for each region r: the struct's hazards (with its coupled rows),
//      clamped at zero; the normals of counter slots r * N_TRANS + k of the
//      day's `slots` (ctr_slots: max(8, R * N_TRANS rounded up to 8)); the
//      tau-leap, the drain in declaration order and the stoichiometry; and
//      the pooled sums x_r0 + x_r1 + ... of each observed compartment, left
//      to right;
//   3. the running summary distance over the channels, region-major
//      (r * N_OBS + m), or over the N_OBS pooled ones.
// Region r's population is population / R in float32 (population at R = 1);
// region seed_region gets a0 * 1, r0 * 1, d0 * 1, every other one a0 * 0 and
// so on. An intervention schedule scales the parameters of every region.
//
// The variants are the flat kernel's (CUM, LOG1P, L1, WAVE; chosen on the
// host), and so are the two entries: abc_sim_regional_distance_<struct>
// (theta in [W, B]) and abc_sim_regional_wave_<struct> (theta drawn in the
// kernel as UniformBoxPrior.sample does, written [B, W], NaN distances as
// +inf; sample b hashes on offset + b, as in the flat wave entry). The loops over regions are not unrolled (#pragma unroll 1) and
// pooling picks values, not code, so that the instruction census
// (kernels/sass.py, `regional_census`) finds one loop a step of the day.
//
// Build with --fmad=false, as every abc_sim source.
#pragma once

#include <type_traits>

#include "abc_sim.cuh"

namespace {

constexpr int MAX_REGIONS = 128;

// N_COUPLED of a struct that declares it, else 0 (the flat structs)
template <class M, class = void>
struct coupled_count {
  static constexpr int value = 0;
};
template <class M>
struct coupled_count<M, std::void_t<decltype(M::N_COUPLED)>> {
  static constexpr int value = M::N_COUPLED;
};

// N_RCONST of a struct that declares it (rows worked out once from the
// matrix and the populations, after the coupled rows), else 0
template <class M, class = void>
struct rconst_count {
  static constexpr int value = 0;
};
template <class M>
struct rconst_count<M, std::void_t<decltype(M::N_RCONST)>> {
  static constexpr int value = M::N_RCONST;
};

// Whether a struct makes the rows the matrix multiplies itself
// (M::coupled_inputs(x, pop, v)); else they are its coupled compartments.
template <class M, class = void>
struct has_coupled_inputs {
  static constexpr bool value = false;
};
template <class M>
struct has_coupled_inputs<M, std::void_t<decltype(&M::coupled_inputs)>> {
  static constexpr bool value = true;
};

// The region geometry of a launch: regions, the seeded one, whether the
// observed compartments pool over the regions, the summary channels and the
// day's counter slots.
struct Geo {
  int R, seed_region, pool, n_chan;
  uint32_t day_stride;  // 2 * slots * P2: one day's step of the hash word
};

template <class Model, int V>
__global__ void __launch_bounds__(MAX_BLOCK)
    abc_sim_regional_kernel(const float* __restrict__ theta_in,  // [W, B] (theta-in entry)
                            const float* __restrict__ obs,       // [n_chan, T]
                            const float* __restrict__ mob,       // [R, R] (coupled models)
                            const float* __restrict__ weights,   // [n_chan]
                            float* __restrict__ theta_out,       // [B, W] (wave entry)
                            float* __restrict__ out,             // [B]
                            int B, int T, Geo g, Consts c,
                            const __grid_constant__ Box<Model::N_PARAMS> box,
                            const __grid_constant__ Sched<Model::N_PARAMS> sched,
                            const int* __restrict__ gate,        // null, or 0: writes nothing
                            const uint32_t* __restrict__ seeds) {  // null, or the wave's seeds
  constexpr int C = Model::N_STATE, TR = Model::N_TRANS, NO = Model::N_OBS;
  constexpr int NC = coupled_count<Model>::value;
  static_assert(Model::N_PARAMS <= MAX_PARAMS, "too many parameters");
  if (gate != nullptr && *gate == 0) return;  // the same in every thread
  const uint32_t sim_seed = seeds != nullptr ? seeds[0] : c.seed;
  const uint32_t prior_seed = seeds != nullptr ? seeds[1] : box.seed;
  const int R = g.R, n_chan = g.n_chan;
  extern __shared__ float smem[];
  float* obs_s = smem;                         // [n_chan * T]
  float* w_s = obs_s + n_chan * T;             // [n_chan]
  float* mob_s = w_s + n_chan;                 // [R * R], coupled models only
  for (int i = threadIdx.x; i < n_chan * T; i += blockDim.x) obs_s[i] = obs[i];
  for (int i = threadIdx.x; i < n_chan; i += blockDim.x) w_s[i] = weights[i];
  if constexpr (NC > 0) {
    for (int i = threadIdx.x; i < R * R; i += blockDim.x) mob_s[i] = mob[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = sched.width();
  const uint32_t idx = c.offset + static_cast<uint32_t>(b);  // the sample's hash index
  Sample<Model, V> s;  // its parameters p, the theta draw and the windows
  s.load_theta(theta_in, theta_out, b, idx, B, box, prior_seed, W);

  float x[MAX_REGIONS * C];
  float cum[MAX_REGIONS * NO], bin[MAX_REGIONS * NO];
  float cpl[MAX_REGIONS * (NC > 0 ? NC : 1)];
  const float pop_r = R > 1 ? c.pop / static_cast<float>(R) : c.pop;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const float z = r == g.seed_region ? 1.0f : 0.0f;
    Model::initial(s.p, pop_r, c.a0 * z, c.r0 * z, c.d0 * z, x + r * C);
  }
#pragma unroll 1
  for (int ch = 0; ch < n_chan; ++ch) cum[ch] = bin[ch] = 0.0f;
  float acc = 0.0f;
  int next_flush = c.bin_days - 1;

  // one running summary channel: the flat kernel's update (Sample::day)
  auto channel = [&](int ch, float xm, int day, float flush) {
    float bv;
    if constexpr ((V & CUM) != 0) {
      cum[ch] = cum[ch] + xm;
      bv = cum[ch];
    } else {
      bv = bin[ch] + xm;
    }
    float sv = bv;
    if constexpr ((V & LOG1P) != 0) sv = log1pf(bv < 0.0f ? 0.0f : bv);
    const float diff = sv - obs_s[ch * T + day];
    const float term = (V & L1) != 0 ? fabsf(diff) : diff * diff;
    acc = acc + flush * (w_s[ch] * term);
    bin[ch] = bv * (1.0f - flush);
  };

  const bool wave = (V & WAVE) != 0;
  const float* col = wave ? theta_out + static_cast<size_t>(b) * W : theta_in + b;
  const size_t stride = wave ? 1 : static_cast<size_t>(B);
  const uint32_t base = rng::sample_base(sim_seed, idx);
  uint32_t day_p2 = 0u;  // day * 2 * slots * P2
  int day = 0;
  for (int w = 0;; ++w) {
    const int end = w < sched.n_windows ? min(sched.bp[w], T) : T;
#pragma unroll 1
    for (; day < end; ++day, day_p2 += g.day_stride) {
      // 1. coupled rows from the start-of-day state
      if constexpr (NC > 0) {
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
          const float* m = mob_s + r * R;
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int j = Model::coupled(k);
            float row = m[0] * x[j];
#pragma unroll 1
            for (int q = 1; q < R; ++q) row = row + m[q] * x[q * C + j];
            cpl[r * NC + k] = row;
          }
        }
      }
      const bool closes = day == next_flush;
      next_flush += closes ? c.bin_days : 0;
      const float flush = (closes || day == T - 1) ? 1.0f : 0.0f;
      float pooled[NO];
      // 2. each region's day
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        float xr[C], n[TR], z[TR];
#pragma unroll
        for (int j = 0; j < C; ++j) xr[j] = x[r * C + j];
        if constexpr (NC > 0) {
          Model::hazards(xr, cpl + r * NC, s.p, pop_r, n);
        } else {
          Model::hazards(xr, s.p, pop_r, n);
        }
        rng::day_normals<TR>(base, day_p2 + 2u * static_cast<uint32_t>(r * TR) * rng::P2, z);
#pragma unroll
        for (int k = 0; k < TR; ++k) {
          const float h = n[k] < 0.0f ? 0.0f : n[k];
          n[k] = floorf(h + sqrtf(h) * z[k]);
        }
        float rem[C];
#pragma unroll
        for (int j = 0; j < C; ++j) rem[j] = xr[j];
#pragma unroll
        for (int k = 0; k < TR; ++k) {
          const float avail = rem[Model::src(k)];
          float t = n[k] < 0.0f ? 0.0f : n[k];
          t = t > avail ? avail : t;
          rem[Model::src(k)] = avail - t;
          n[k] = t;
        }
#pragma unroll
        for (int k = 0; k < TR; ++k) {
          xr[Model::src(k)] -= n[k];
          xr[Model::dst(k)] += n[k];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) x[r * C + j] = xr[j];
        // pooled sums of the observed compartments, x_r0 + x_r1 + ...
#pragma unroll
        for (int m = 0; m < NO; ++m)
          pooled[m] = r == 0 ? xr[Model::observed(m)] : pooled[m] + xr[Model::observed(m)];
      }
      // 3. the summary channels, region-major: R rows of N_OBS channels, or
      // one row of the pooled ones
      const int rows = g.pool ? 1 : R;
#pragma unroll 1
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int m = 0; m < NO; ++m) {
          const float xm = x[r * C + Model::observed(m)];  // r = 0 when pooled
          channel(r * NO + m, g.pool ? pooled[m] : xm, day, flush);
        }
      }
    }
    if (day >= T) break;
    s.enter_window(w + 1, sched, col, stride);
  }
  const float a = acc * c.mean_scale;
  const float d = (V & L1) != 0 ? a : sqrtf(a);
  if constexpr ((V & WAVE) != 0) {
    out[b] = isnan(d) ? __int_as_float(0x7f800000) : d;
  } else {
    out[b] = d;
  }
}

template <class Model, int... V>
auto regional_kernel_table(std::integer_sequence<int, V...>) {
  using Fn = void (*)(const float*, const float*, const float*, const float*, float*, float*,
                      int, int, Geo, Consts, Box<Model::N_PARAMS>, Sched<Model::N_PARAMS>,
                      const int*, const uint32_t*);
  return std::array<Fn, sizeof...(V)>{&abc_sim_regional_kernel<Model, V>...};
}

// N_STATE, N_TRANS, N_PARAMS, N_OBS, N_COUPLED, the coupled compartments,
// N_RCONST, whether the struct makes its coupled inputs, and each
// transition's source and destination (-1: none)
template <class Model>
void regional_shape(int* out) {
  constexpr int NC = coupled_count<Model>::value;
  out[0] = Model::N_STATE;
  out[1] = Model::N_TRANS;
  out[2] = Model::N_PARAMS;
  out[3] = Model::N_OBS;
  out[4] = NC;
  if constexpr (NC > 0) {
    for (int k = 0; k < NC; ++k) out[5 + k] = Model::coupled(k);
  }
  int* more = out + 5 + NC;
  more[0] = rconst_count<Model>::value;
  more[1] = has_coupled_inputs<Model>::value ? 1 : 0;
  for (int k = 0; k < Model::N_TRANS; ++k) {
    more[2 + 2 * k] = Model::src(k);
    more[3 + 2 * k] = Model::dst(k);
  }
}

// The checked arguments of a regional launch, shared by both routes (the
// thread-per-sample kernel here, the warp-per-sample one in
// abc_sim_regional_warp.cuh): the geometry, the constants, the schedule, the
// box of the wave entry and the variant. Returns cudaErrorInvalidValue for
// arguments the kernels do not take (R past MAX_REGIONS among them).
template <class Model>
struct RegionalArgs {
  Geo g;
  Consts c;
  Sched<Model::N_PARAMS> sched;
  Box<Model::N_PARAMS> box;
  int variant;
};

template <class Model>
int read_regional_args(const void* obs, const void* mob, const void* weights,
                       const float* fconst, const int* iconst, const float* lows,
                       const float* highs, uint32_t prior_seed, bool wave, int B, int T, int R,
                       int seed_region, int pool, int block, int max_block, uint32_t offset,
                       RegionalArgs<Model>& a, int max_regions = MAX_REGIONS) {
  constexpr int NO = Model::N_OBS;
  constexpr int NC = coupled_count<Model>::value;
  if (B <= 0 || T <= 0 || block <= 0 || block > max_block) return cudaErrorInvalidValue;
  if (!index_range_ok(offset, B)) return cudaErrorInvalidValue;
  if (R < 1 || R > max_regions || seed_region < 0 || seed_region >= R) return cudaErrorInvalidValue;
  if (pool != 0 && pool != 1) return cudaErrorInvalidValue;
  if (obs == nullptr || weights == nullptr || (NC > 0 && mob == nullptr))
    return cudaErrorInvalidValue;
  Geo& g = a.g;
  g.R = R;
  g.seed_region = seed_region;
  g.pool = pool && R > 1;
  g.n_chan = g.pool ? NO : R * NO;
  const int slots = R * Model::N_TRANS <= 8 ? 8 : (R * Model::N_TRANS + 7) / 8 * 8;
  g.day_stride = 2u * static_cast<uint32_t>(slots) * rng::P2;
  Consts& c = a.c;
  c.pop = fconst[F_POP];
  c.a0 = fconst[F_A0];
  c.r0 = fconst[F_R0];
  c.d0 = fconst[F_D0];
  c.mean_scale = fconst[F_MEAN_SCALE];
  for (int m = 0; m < MAX_CHAN; ++m) c.weights[m] = 0.0f;  // read from `weights`
  c.seed = static_cast<uint32_t>(iconst[I_SEED]);
  c.offset = offset;
  c.bin_days = iconst[I_BIN_DAYS];
  if (c.bin_days < 1) return cudaErrorInvalidValue;
  const int power = iconst[I_POWER], root = iconst[I_ROOT];
  if (!((power == 2 && root == 1) || (power == 1 && root == 0))) return cudaErrorInvalidValue;
  if (!read_sched(iconst, a.sched)) return cudaErrorInvalidValue;
  a.box = Box<Model::N_PARAMS>{};
  if (wave) {
    for (int j = 0; j < a.sched.width(); ++j) {
      a.box.lo[j] = lows[j];
      a.box.hi[j] = highs[j];
    }
    a.box.seed = prior_seed;
  }
  a.variant = (iconst[I_CUMULATIVE] == 1 ? CUM : 0) | (iconst[I_LOG1P] == 1 ? LOG1P : 0) |
              (power == 1 ? L1 : 0) | (wave ? WAVE : 0);
  return cudaSuccess;
}

// Refuse `smem` bytes of dynamic shared memory past the card's opt-in limit;
// opt `kernel` in above 48 KB.
template <class Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
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
  return cudaSuccess;
}

template <class Model>
int launch_abc_sim_regional(const void* theta_in, const void* obs, const void* mob,
                            const void* weights, void* theta_out, void* out,
                            const float* fconst, const int* iconst, const float* lows,
                            const float* highs, uint32_t prior_seed, bool wave, int B, int T,
                            int R, int seed_region, int pool, int block, void* stream,
                            const int* gate, uint32_t offset = 0u,
                            const uint32_t* seeds = nullptr) {
  constexpr int NC = coupled_count<Model>::value;
  RegionalArgs<Model> a;
  int err = read_regional_args<Model>(obs, mob, weights, fconst, iconst, lows, highs, prior_seed,
                                      wave, B, T, R, seed_region, pool, block, MAX_BLOCK,
                                      offset, a);
  if (err != cudaSuccess) return err;
  static const auto table =
      regional_kernel_table<Model>(std::make_integer_sequence<int, N_VARIANTS>{});
  const auto kernel = table[a.variant];
  const size_t smem = sizeof(float) * (static_cast<size_t>(a.g.n_chan) * (T + 1) +
                                       (NC > 0 ? static_cast<size_t>(R) * R : 0));
  err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + block - 1) / block;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta_in), static_cast<const float*>(obs),
      static_cast<const float*>(mob), static_cast<const float*>(weights),
      static_cast<float*>(theta_out), static_cast<float*>(out), B, T, a.g, a.c, a.box, a.sched,
      gate, seeds);
  return cudaGetLastError();
}

}  // namespace

// The C interface of one struct's regional kernel.
//
// abc_sim_regional_distance_<name>: theta [W, B], obs [n_chan, T], mob [R, R]
// (may be null for a model with no coupled compartment), weights [n_chan]
// and out [B] are device pointers, float32; fconst [N_FCONST] (its weight
// lanes unused) and iconst [N_ICONST] are host arrays copied into the
// kernel's parameters. n_chan is N_OBS when pool is 1 and R > 1, else
// R * N_OBS.
// abc_sim_regional_wave_<name>: theta [B, W] (16-byte aligned) and dist [B]
// are device outputs; lows and highs [W] are host arrays; sample b hashes on
// offset + b (cudaErrorInvalidValue where offset + B passes 2^32); seeds is
// null or the wave's two device seeds, as the flat wave entry takes them
// (abc_sim.cuh).
// abc_sim_regional_shape_<name>(out): N_STATE, N_TRANS, N_PARAMS, N_OBS,
// N_COUPLED, the coupled compartments, N_RCONST, whether the struct makes its
// coupled inputs, and each transition's source and destination (out holds
// 7 + N_COUPLED + 2 * N_TRANS ints); abc_sim_max_regions(): MAX_REGIONS.
// ABC_SIM_REGIONAL_LAYOUT_EXPORTS alone gives these and the layout sizes, for
// a struct that only the tile route runs.
// Both entries take a gate, as the flat ones do (abc_sim.cuh; the wave
// entry's last argument but its offset): a device int that makes the launch
// write nothing when it reads 0, or null.
// Both entries return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take, R past
// MAX_REGIONS among them).
#define ABC_SIM_REGIONAL_LAYOUT_EXPORTS(name, Model)                                            \
  extern "C" {                                                                                  \
  int abc_sim_n_fconst() { return N_FCONST; }                                                   \
  int abc_sim_n_iconst() { return N_ICONST; }                                                   \
  int abc_sim_max_chan() { return MAX_CHAN; }                                                   \
  int abc_sim_max_block() { return MAX_BLOCK; }                                                 \
  int abc_sim_max_regions() { return MAX_REGIONS; }                                             \
  int abc_sim_regional_shape_##name(int* out) {                                                 \
    regional_shape<Model>(out);                                                                 \
    return 0;                                                                                   \
  }                                                                                             \
  const char* kernel_error_string(int code) {                                                   \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                                  \
  }                                                                                             \
  }

#define ABC_SIM_REGIONAL_EXPORTS(name, Model)                                                   \
  ABC_SIM_REGIONAL_LAYOUT_EXPORTS(name, Model)                                                  \
  extern "C" {                                                                                  \
  int abc_sim_regional_distance_##name(const void* theta, const void* obs, const void* mob,     \
                                       const void* weights, void* out, const void* fconst,      \
                                       const void* iconst, int B, int T, int R,                 \
                                       int seed_region, int pool, int block, void* stream,      \
                                       const void* gate) {                                      \
    return launch_abc_sim_regional<Model>(                                                      \
        theta, obs, mob, weights, nullptr, out, static_cast<const float*>(fconst),              \
        static_cast<const int*>(iconst), nullptr, nullptr, 0u, false, B, T, R, seed_region,     \
        pool, block, stream, static_cast<const int*>(gate));                                    \
  }                                                                                             \
  int abc_sim_regional_wave_##name(unsigned int prior_seed, const void* lows, const void* highs, \
                                   const void* obs, const void* mob, const void* weights,       \
                                   void* theta, void* dist, const void* fconst,                 \
                                   const void* iconst, int B, int T, int R, int seed_region,    \
                                   int pool, int block, void* stream, const void* gate,         \
                                   unsigned int offset, const void* seeds) {                    \
    return launch_abc_sim_regional<Model>(                                                      \
        nullptr, obs, mob, weights, theta, dist, static_cast<const float*>(fconst),             \
        static_cast<const int*>(iconst), static_cast<const float*>(lows),                       \
        static_cast<const float*>(highs), prior_seed, true, B, T, R, seed_region, pool, block,  \
        stream, static_cast<const int*>(gate), offset, static_cast<const uint32_t*>(seeds));    \
  }                                                                                             \
  }
