// The region axis of the fused ABC simulation kernel for large R on Hopper
// (sm_90a): one warp owns one sample. Each abc_sim_regional_<struct>.cu
// instantiates it beside the thread-per-sample kernel (abc_sim_regional.cuh),
// so one library a struct holds both routes; `abc_sim.regional_route` picks
// one on the host from R and the launch's batch.
//
// Replaces the same part of the TPU kernel as abc_sim_regional.cuh: the
// region axis of src/repro/kernels/abc_sim.py:138 (_kernel), its mobility
// lanes (:95-119), region geometry (:195-208), per-region seeding
// (:220-236), coupled rows (:254-260), per-region hazards and RNG slots
// (:261-276) and region pooling (:287-294).
//
// Why a second kernel. With one thread a sample, a sample's per-region state,
// carries and coupled rows are indexed by a run-time region and live in local
// memory: 3,584 bytes a thread for metapop_seir, far more than L1 holds at 24
// warps an SM, so at R = 100 each of the 9,900 products of the coupled sum
// waits on a word from L2. Here lane l owns regions r = l + 32 i, i <
// MAX_REGIONS / 32 (4), and keeps their state x[4][C], their summary carries
// and their coupled rows in registers, indexed by the unrolled i only:
// ptxas reports no stack and no spills (chip_smoke.py's build phase asserts
// it). The work of a day at R = 100 is about 3,000 warp-instructions a
// sample (sass.regional_warp_census) against about 4,000 issue slots of the
// thread kernel, which was far from its floor; what sets this kernel's pace
// is issue and shared-memory bandwidth, both on chip.
//
// A day, in the TPU kernel body's order, bitwise the plain version
// (kernels/ref.py; epi/engine.py coupled_rows):
//   1. coupled rows. Each lane has written its regions' coupled compartments
//      to its warp's vector xc[k][q] in shared memory (-0 past R); the block
//      staged the mobility matrix transposed in groups of four sources,
//      mob4[((q / 4) * R + r) * 4 + q % 4] = mob[r][q], so a lane reads the
//      four words of a group for its region in one 16-byte load (the 32 lanes
//      read 512 consecutive bytes, no bank conflict) while xc[q..q+3] is a
//      broadcast. Lane l forms the rows of its NR = ceil(R / 32) regions from
//      q = 0 upward: row = -0, then row = row + mob[r][q] * xc[q], so each
//      row keeps the left-to-right order from the first product (-0 + p is
//      p for every float), and each xc word feeds NR products; past R the
//      group's products are +0 * -0 = -0, which leave the row as it is. NR is
//      a template parameter of the row loop, chosen by a switch on the
//      uniform NR.
//   2. the region passes. Pass i (i < NR; passes 1-3 behind a uniform
//      branch) runs region r = l + 32 i of every lane: the struct's hazards
//      with its coupled rows, clamped at zero; the normals of counter slots
//      r * N_TRANS + k of the day's `slots` (ctr_slots), as the thread kernel
//      draws them; the tau-leap, the drain in declaration order and the
//      stoichiometry; the new coupled compartments to xc for the next day;
//      and the terms flush * (w * term) of its channels r * N_OBS + m, from
//      its own carries, to the warp's channel vector buf (0 for a region past
//      R). Pooled, the pass writes the observed compartments to buf instead
//      (values are picked, not code, so the census walks one path).
//   3. the serial chains, in today's order: pooled, the sums x_r0 + x_r1 +
//      ... over the regions, left to right, then the N_OBS pooled channels;
//      else acc = acc + buf[ch] over the channels region-major, eight at a
//      time from two 16-byte broadcast reads (the tail past n_chan holds +0,
//      and acc + 0 is acc: acc starts at +0 and never becomes -0). Every
//      lane runs the chain, so every lane holds acc. A term that is not
//      finite turns acc to NaN even where flush is 0, as before.
// theta is the same in every lane: lane 0 draws it (Sample::load_theta, the
// flat kernel's) or reads it, and writes theta_out; the others take p by
// shuffle. The block stages the observed summary as [T][n_chan], so that a
// day's reads across lanes are consecutive, and the channel weights.
//
// Tensor cores were considered for step 1 and declined: a day's coupled rows
// are a [samples x R] x [R x R] product, but wgmma sums in its own order and
// TF32 rounds its inputs, which breaks the bitwise agreement with the plain
// version that every route keeps.
//
// Blocks hold block / 32 samples and share the staging of mobility (41 KB
// at R = 100) and of the observed summary (39 KB at R = 100 and 49 days for
// metapop_seir); each warp adds (N_COUPLED + N_OBS) * MAX_REGIONS floats
// (1.5 KB for metapop_seir). WARP_MAX_BLOCK is 512 threads: the register
// budget of 128 a thread keeps every struct's state in registers (ptxas
// gives 56-127), where 1,024 would cap it at 64. The wrapper's block,
// WARP_DEFAULT_BLOCK (kernels/abc_sim.py), is 512 (16 samples), the fastest
// of 128, 256, 384 and 512 threads at R = 100 (PERF.md): there metapop_seir
// holds 63 registers and 103 KB of shared memory a block, so an SM takes
// two blocks, 32 warps; siard and seiard (82-127 registers) one, 16 warps.
//
// The variants are the flat kernel's (CUM, LOG1P, L1, WAVE), and the two
// entries the thread route's with `_warp` in their names:
// abc_sim_regional_distance_warp_<struct> and
// abc_sim_regional_wave_warp_<struct>. Build with --fmad=false, as every
// abc_sim source.
#pragma once

#include "abc_sim_regional.cuh"

namespace {

constexpr int WARP_SLOTS = MAX_REGIONS / 32;  // regions a lane: r = lane + 32 i
constexpr int WARP_MAX_BLOCK = 512;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Floats of one warp's shared vectors: xc [N_COUPLED][MAX_REGIONS] and the
// channel vector buf [MAX_REGIONS * N_OBS]; a multiple of 4, so every warp's
// vectors start on 16 bytes.
template <class Model>
__host__ __device__ constexpr int warp_floats() {
  return (coupled_count<Model>::value + Model::N_OBS) * MAX_REGIONS;
}

// One running summary channel (the flat kernel's update, Sample::day): the
// carry, and the value flush * (w * term) that the distance adds.
template <int V>
__device__ __forceinline__ float channel_value(float& cum, float& bin, float xm, float ob,
                                               float w, float flush) {
  float bv;
  if constexpr ((V & CUM) != 0) {
    cum = cum + xm;
    bv = cum;
  } else {
    bv = bin + xm;
  }
  float sv = bv;
  if constexpr ((V & LOG1P) != 0) sv = log1pf(bv < 0.0f ? 0.0f : bv);
  const float diff = sv - ob;
  const float term = (V & L1) != 0 ? fabsf(diff) : diff * diff;
  bin = bv * (1.0f - flush);
  return flush * (w * term);
}

// The coupled rows of the NR regions lane l owns in slots i < NR: for each
// coupled compartment k, rows[i][k] = mob[r][0] * x_0 + mob[r][1] * x_1 + ...,
// r = l + 32 i, left to right from the first product: the row starts at -0,
// and -0 + p is p for every float p. mob4 is the matrix in groups of four
// sources, mob4[((q / 4) * R + r) * 4 + q % 4] = mob[r][q], so a lane reads a
// group's four words in one 16-byte load and the 32 lanes 512 consecutive
// bytes; xc4 a broadcast. Past R a group holds mob +0 and xc -0, whose
// product -0 leaves a row as it is. Rows past R are not used (mob4 holds 128
// floats of padding, so their reads stay inside).
template <class Model, int NR, int NCX>
__device__ __forceinline__ void warp_coupled_rows(const float4* __restrict__ mob4,
                                                  const float4* __restrict__ xc4, int R,
                                                  int lane, float (&rows)[WARP_SLOTS][NCX]) {
  constexpr int NC = coupled_count<Model>::value;
  float row[NR][NCX];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) row[i][k] = -0.0f;
  const float4* m = mob4 + lane;
  const int groups = (R + 3) >> 2;
#pragma unroll 1
  for (int q4 = 0; q4 < groups; ++q4, m += R) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float4 x = xc4[k * (MAX_REGIONS / 4) + q4];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float4 w = m[32 * i];
        float v = row[i][k];
        v = v + w.x * x.x;
        v = v + w.y * x.y;
        v = v + w.z * x.z;
        v = v + w.w * x.w;
        row[i][k] = v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) rows[i][k] = row[i][k];
}

template <class Model, int V>
__global__ void __launch_bounds__(WARP_MAX_BLOCK)
    abc_sim_regional_warp_kernel(const float* __restrict__ theta_in,  // [W, B] (theta-in entry)
                                 const float* __restrict__ obs,       // [n_chan, T]
                                 const float* __restrict__ mob,       // [R, R] (coupled models)
                                 const float* __restrict__ weights,   // [n_chan]
                                 float* __restrict__ theta_out,       // [B, W] (wave entry)
                                 float* __restrict__ out,             // [B]
                                 int B, int T, Geo g, Consts c,
                                 const __grid_constant__ Box<Model::N_PARAMS> box,
                                 const __grid_constant__ Sched<Model::N_PARAMS> sched,
                                 const int* __restrict__ gate) {  // null, or 0: writes nothing
  constexpr int C = Model::N_STATE, TR = Model::N_TRANS, NO = Model::N_OBS;
  constexpr int NC = coupled_count<Model>::value, NCX = NC > 0 ? NC : 1;
  constexpr int S = WARP_SLOTS;
  static_assert(Model::N_PARAMS <= MAX_PARAMS, "too many parameters");
  if (gate != nullptr && *gate == 0) return;  // the same in every thread
  const int R = g.R, n_chan = g.n_chan;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xc_s = smem + warp * warp_floats<Model>();   // [N_COUPLED][MAX_REGIONS]
  float* buf = xc_s + NC * MAX_REGIONS;                // [MAX_REGIONS * N_OBS]
  float* mob_s = smem + warps * warp_floats<Model>();  // mob4: [ceil(R / 4)][R][4], + 128
  const int mob_floats = NC > 0 ? 4 * ((R + 3) >> 2) * R + 128 : 0;
  float* obs_s = mob_s + mob_floats;                   // [T][n_chan]
  float* w_s = obs_s + n_chan * T;                     // [n_chan]
  if constexpr (NC > 0) {
    for (int e = threadIdx.x; e < mob_floats; e += blockDim.x) {
      const int g4 = e / (4 * R), r = (e >> 2) - g4 * R, q = 4 * g4 + (e & 3);
      mob_s[e] = g4 < (R + 3) >> 2 && q < R ? mob[r * R + q] : 0.0f;
    }
  }
  for (int e = threadIdx.x; e < n_chan * T; e += blockDim.x) {
    const int ch = e / T;
    obs_s[(e - ch * T) * n_chan + ch] = obs[e];
  }
  for (int e = threadIdx.x; e < n_chan; e += blockDim.x) w_s[e] = weights[e];
  __syncthreads();

  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp
  const int W = sched.width();
  const uint32_t idx = c.offset + static_cast<uint32_t>(b);  // the sample's hash index
  Sample<Model, V> s;  // its parameters p, the theta draw and the windows
  if (lane == 0) s.load_theta(theta_in, theta_out, b, idx, B, box, W);
#pragma unroll
  for (int j = 0; j < Model::N_PARAMS; ++j) s.p[j] = __shfl_sync(FULL_MASK, s.p[j], 0);
  __syncwarp();  // theta_out's row is read again where a window starts

  const int nr = (R + 31) >> 5;  // slots that hold a region in some lane
  const bool pool = g.pool != 0;
  const float pop_r = R > 1 ? c.pop / static_cast<float>(R) : c.pop;
  float x[S][C], cum[S][NO], bin[S][NO], rows[S][NCX];
  float pcum[NO], pbin[NO];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int r = lane + 32 * i;
    const float z = r == g.seed_region ? 1.0f : 0.0f;
    Model::initial(s.p, pop_r, c.a0 * z, c.r0 * z, c.d0 * z, x[i]);
#pragma unroll
    for (int m = 0; m < NO; ++m) cum[i][m] = bin[i][m] = 0.0f;
#pragma unroll
    for (int k = 0; k < NCX; ++k) rows[i][k] = 0.0f;
    if constexpr (NC > 0) {
#pragma unroll
      for (int k = 0; k < NC; ++k)
        xc_s[k * MAX_REGIONS + r] = r < R ? x[i][Model::coupled(k)] : -0.0f;
    }
  }
#pragma unroll
  for (int m = 0; m < NO; ++m) pcum[m] = pbin[m] = 0.0f;
  __syncwarp();
  float acc = 0.0f;
  int next_flush = c.bin_days - 1;

  const bool wave = (V & WAVE) != 0;
  const float* col = wave ? theta_out + static_cast<size_t>(b) * W : theta_in + b;
  const size_t stride = wave ? 1 : static_cast<size_t>(B);
  const uint32_t base = rng::sample_base(c.seed, idx);
  uint32_t day_p2 = 0u;  // day * 2 * slots * P2
  int day = 0;
  for (int win = 0;; ++win) {
    const int end = win < sched.n_windows ? min(sched.bp[win], T) : T;
#pragma unroll 1
    for (; day < end; ++day, day_p2 += g.day_stride) {
      // 1. coupled rows from the start-of-day state in xc
      if constexpr (NC > 0) {
        const float4* mob4 = reinterpret_cast<const float4*>(mob_s);
        const float4* xc4 = reinterpret_cast<const float4*>(xc_s);
        switch (nr) {
          case 1:
            warp_coupled_rows<Model, 1>(mob4, xc4, R, lane, rows);
            break;
          case 2:
            warp_coupled_rows<Model, 2>(mob4, xc4, R, lane, rows);
            break;
          case 3:
            warp_coupled_rows<Model, 3>(mob4, xc4, R, lane, rows);
            break;
          default:
            warp_coupled_rows<Model, 4>(mob4, xc4, R, lane, rows);
        }
      }
      __syncwarp();  // xc read, and the last day's chain read buf
      const bool closes = day == next_flush;
      next_flush += closes ? c.bin_days : 0;
      const float flush = (closes || day == T - 1) ? 1.0f : 0.0f;
      const float* obs_day = obs_s + day * n_chan;
      // 2. the region passes
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (i == 0 || i < nr) {
          const int r = lane + 32 * i;
          const bool valid = r < R;
          float n[TR], z[TR];
          if constexpr (NC > 0) {
            Model::hazards(x[i], rows[i], s.p, pop_r, n);
          } else {
            Model::hazards(x[i], s.p, pop_r, n);
          }
          rng::day_normals<TR>(base, day_p2 + 2u * static_cast<uint32_t>(r * TR) * rng::P2, z);
#pragma unroll
          for (int k = 0; k < TR; ++k) {
            const float h = n[k] < 0.0f ? 0.0f : n[k];
            n[k] = floorf(h + sqrtf(h) * z[k]);
          }
          float rem[C];
#pragma unroll
          for (int j = 0; j < C; ++j) rem[j] = x[i][j];
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
            x[i][Model::src(k)] -= n[k];
            x[i][Model::dst(k)] += n[k];
          }
          if constexpr (NC > 0) {
#pragma unroll
            for (int k = 0; k < NC; ++k)
              xc_s[k * MAX_REGIONS + r] = valid ? x[i][Model::coupled(k)] : -0.0f;
          }
#pragma unroll
          for (int m = 0; m < NO; ++m) {
            const int ch = r * NO + m, own = valid && !pool ? ch : 0;
            const float xm = x[i][Model::observed(m)];
            const float v =
                channel_value<V>(cum[i][m], bin[i][m], xm, obs_day[own], w_s[own], flush);
            buf[ch] = pool ? xm : (valid ? v : 0.0f);
          }
        }
      }
      __syncwarp();  // buf and xc written
      // 3. the serial chains, in channel order
      if (pool) {
        float pooled[NO];
#pragma unroll
        for (int m = 0; m < NO; ++m) pooled[m] = buf[m];
#pragma unroll 1
        for (int r = 1; r < R; ++r) {
#pragma unroll
          for (int m = 0; m < NO; ++m) pooled[m] = pooled[m] + buf[r * NO + m];
        }
#pragma unroll
        for (int m = 0; m < NO; ++m)
          acc = acc + channel_value<V>(pcum[m], pbin[m], pooled[m], obs_day[m], w_s[m], flush);
      } else {
        const float4* v4 = reinterpret_cast<const float4*>(buf);
        const int n8 = (n_chan + 7) >> 3;
#pragma unroll 1
        for (int q = 0; q < n8; ++q) {
          const float4 u = v4[2 * q], v = v4[2 * q + 1];
          acc = acc + u.x;
          acc = acc + u.y;
          acc = acc + u.z;
          acc = acc + u.w;
          acc = acc + v.x;
          acc = acc + v.y;
          acc = acc + v.z;
          acc = acc + v.w;
        }
      }
    }
    if (day >= T) break;
    s.enter_window(win + 1, sched, col, stride);
  }
  if (lane == 0) {
    const float a = acc * c.mean_scale;
    const float d = (V & L1) != 0 ? a : sqrtf(a);
    if constexpr ((V & WAVE) != 0) {
      out[b] = isnan(d) ? __int_as_float(0x7f800000) : d;
    } else {
      out[b] = d;
    }
  }
}

template <class Model, int... V>
auto regional_warp_kernel_table(std::integer_sequence<int, V...>) {
  using Fn = void (*)(const float*, const float*, const float*, const float*, float*, float*,
                      int, int, Geo, Consts, Box<Model::N_PARAMS>, Sched<Model::N_PARAMS>,
                      const int*);
  return std::array<Fn, sizeof...(V)>{&abc_sim_regional_warp_kernel<Model, V>...};
}

template <class Model>
int launch_abc_sim_regional_warp(const void* theta_in, const void* obs, const void* mob,
                                 const void* weights, void* theta_out, void* out,
                                 const float* fconst, const int* iconst, const float* lows,
                                 const float* highs, uint32_t prior_seed, bool wave, int B,
                                 int T, int R, int seed_region, int pool, int block,
                                 void* stream, const int* gate, uint32_t offset = 0u) {
  constexpr int NC = coupled_count<Model>::value;
  if (block % 32 != 0) return cudaErrorInvalidValue;
  RegionalArgs<Model> a;
  int err = read_regional_args<Model>(obs, mob, weights, fconst, iconst, lows, highs, prior_seed,
                                      wave, B, T, R, seed_region, pool, block, WARP_MAX_BLOCK,
                                      offset, a);
  if (err != cudaSuccess) return err;
  static const auto table =
      regional_warp_kernel_table<Model>(std::make_integer_sequence<int, N_VARIANTS>{});
  const auto kernel = table[a.variant];
  const int warps = block / 32;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(warps) * warp_floats<Model>() +
                       (NC > 0 ? 4 * static_cast<size_t>((R + 3) / 4) * R + 128 : 0) +
                       static_cast<size_t>(a.g.n_chan) * (T + 1));
  err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + warps - 1) / warps;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta_in), static_cast<const float*>(obs),
      static_cast<const float*>(mob), static_cast<const float*>(weights),
      static_cast<float*>(theta_out), static_cast<float*>(out), B, T, a.g, a.c, a.box, a.sched,
      gate);
  return cudaGetLastError();
}

}  // namespace

// The C interface of one struct's warp-per-sample kernel: the thread route's
// entries (ABC_SIM_REGIONAL_EXPORTS) with `_warp` in their names and the
// same arguments, the gate and the wave entry's offset too, `block` in threads (block / 32
// samples a block, at most abc_sim_warp_max_block()).
#define ABC_SIM_REGIONAL_WARP_EXPORTS(name, Model)                                               \
  extern "C" {                                                                                  \
  int abc_sim_warp_max_block() { return WARP_MAX_BLOCK; }                                       \
  int abc_sim_regional_distance_warp_##name(const void* theta, const void* obs,                 \
                                            const void* mob, const void* weights, void* out,    \
                                            const void* fconst, const void* iconst, int B,      \
                                            int T, int R, int seed_region, int pool, int block, \
                                            void* stream, const void* gate) {                   \
    return launch_abc_sim_regional_warp<Model>(                                                 \
        theta, obs, mob, weights, nullptr, out, static_cast<const float*>(fconst),              \
        static_cast<const int*>(iconst), nullptr, nullptr, 0u, false, B, T, R, seed_region,     \
        pool, block, stream, static_cast<const int*>(gate));                                    \
  }                                                                                             \
  int abc_sim_regional_wave_warp_##name(unsigned int prior_seed, const void* lows,              \
                                        const void* highs, const void* obs, const void* mob,    \
                                        const void* weights, void* theta, void* dist,           \
                                        const void* fconst, const void* iconst, int B, int T,   \
                                        int R, int seed_region, int pool, int block,            \
                                        void* stream, const void* gate, unsigned int offset) {  \
    return launch_abc_sim_regional_warp<Model>(                                                 \
        nullptr, obs, mob, weights, theta, dist, static_cast<const float*>(fconst),             \
        static_cast<const int*>(iconst), static_cast<const float*>(lows),                       \
        static_cast<const float*>(highs), prior_seed, true, B, T, R, seed_region, pool, block,  \
        stream, static_cast<const int*>(gate), offset);                                         \
  }                                                                                             \
  }
