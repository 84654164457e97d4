// Forward flash attention in float32 on Hopper's tensor cores (sm_90a,
// 3xTF32 wgmma): the float32 route.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:38 (_kernel,
// launched by flash_attention_kernel at :89, wrapped by kernels/ops.py:240)
// for float32 inputs; bf16 inputs go to flash_attention_wgmma.cu. It computes
// what that kernel computes: for each (batch, head, query row),
// softmax(softcap(scale * q . k)) @ v over the keys that the causal mask, the
// sliding window and the true key length allow, with an online softmax whose
// scores, p, running max m, sum l and accumulator acc are float32, and the
// float32 output acc / max(l, 1e-30). A row with no allowed key writes 0.
// Query position i is aligned with key position i. GQA reads kv head
// h / (H / KH).
//
// Layout: q and o are [B, Sq, H, D], k and v [B, Skv, KH, D] (the model's
// layout), read through their batch, sequence and head strides with the last
// dimension contiguous. With D a multiple of 4, K and V rows are read in
// 16-byte pieces, so the bases must be 16-byte aligned and the strides
// multiples of 4 (the wrapper checks); any other D is read element by
// element. Q is read element by element once a block.
//
// Numerics. A tf32 product keeps 10 bits of each factor, too few for the
// float32 bar (rtol 3e-4, atol 3e-5 of the plain version). Each factor x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and each product
// a . b is taken as a_hi b_hi + a_lo b_hi + a_hi b_lo (3xTF32), accumulated
// in float32 by the tensor core: about 21 bits of each factor. Both products
// need all three terms: dropping a lo term of either fails the bar
// (tests/test_torch_flash.py emulates each split). Q is scaled before the
// split, as the plain version scales it, and its lo is kept to bf16 (8
// bits; q_hi + q_lo still holds 20 bits of q), which halves its shared
// memory; the emulation meets the bar by the same margin as with a TF32 lo.
//
// What bounds it: 4 * D operations a (query, key) pair that the mask allows,
// done three times over in TF32 (494.7 TFLOP/s dense on the H100 SXM),
// against q + k + v + o moved once: the tensor cores bound it, at three TF32
// products for each float32 one.
//
// Design. tf32 wgmma reads shared memory only K-major and takes no
// transpose, and every operand needs a hi and a lo copy. Two kernels a call:
//   1. split_kv_kernel splits K and V once into hi and lo tiles of BK = 32
//      keys in global scratch (the wrapper allocates it), each tile already
//      the image that the attention kernel's shared memory wants: K as
//      keys x DP, K-major in the 128-byte swizzle; V transposed, DP x keys,
//      its keys permuted (wgmma.cuh's tf32_kpos). Done in every attention
//      block, this split cost a third of the time: each kv head's tiles are
//      read by H / KH heads times Sq / 64 query tiles.
//   2. flash_fwd_tf32_kernel: a block is one warpgroup (128 threads) that
//      owns BQ = 64 query rows of one (batch, head) and keeps its float32
//      accumulator (64 x DP, DP/2 registers a thread), m and l in registers.
//      The head dimension is padded to DP = 64, 128 or 256 with zeros.
//      - s = Q K^T: A = Q hi / lo from registers, B = K hi / lo from
//        shared memory. Q is split once a block, into shared memory in the
//        order of the register operand, so a k8 step costs a thread one
//        16-byte load (hi) and one 8-byte load (lo), KG steps ahead of the
//        wgmmas that read them. Split again at every step from raw Q, the
//        scores took a third more time; with Q_hi as a shared-memory
//        operand, whose 64 rows each wgmma reads again, 3% more
//        (experiments/flash_tf32_parts.py).
//      - acc += P V: A = p from registers (the score accumulator itself,
//        split into hi and lo; its 8 columns of a k step sit where the
//        operand's k order is permuted, as V^T's keys are), B = V^T hi / lo
//        from shared memory.
//      The tile images come in by cp.async, one tile at a time: each
//      32-column block of K(t + 1) as soon as s(t) is done with it (so most
//      of K(t + 1) is in flight during s(t)), V(t + 1) while s(t + 1) runs.
//      For each tile the warpgroup soft-caps with tanhf, masks (only on
//      tiles that cross the causal diagonal, the window edge or Skv) and
//      updates m, l and acc in the log2 domain with exp2f, as
//      flash_attention_wgmma.cu does. The KV loop starts at the window's
//      first tile and stops at the causal bound; blocks run the heaviest
//      query tiles first (blockIdx.z counts down). Shared memory at DP = 256:
//      K hi + lo 64 KB, V^T hi + lo 64 KB, Q hi 64 KB and Q lo 32 KB (225 KB
//      with alignment), so one block runs on an SM. Shared memory bounds
//      it as much as the tensor cores do: a tile of 32 keys moves about
//      416 KB through it (K, V^T and Q into the products, the copies in),
//      3,300 clocks at 128 bytes a clock, beside 3,100 clocks of TF32
//      tensor work.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;  // query rows a block (one warpgroup)
constexpr int BK = 32;  // keys a tile
constexpr int THREADS = 128;
constexpr int SPLIT_THREADS = 512;  // threads of a block of split_kv_kernel
constexpr int KG = 4;  // k8 steps of s = Q K^T a group of wgmmas: one 32-column block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, H, KH, Sq, Skv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int causal;
  int window;     // 0: no window
  float softcap;  // 0: no softcap
  float scale;
  uint8_t* tiles;  // K and V split into hi + lo tiles, 4 * kv_bytes<DP>() a tile of keys
  int T;           // tiles of BK keys, ceil(Skv / BK)
};

// bytes of one K or V tile (BK keys x DP floats)
template <int DP>
__host__ __device__ constexpr uint32_t kv_bytes() {
  return static_cast<uint32_t>(BK) * DP * 4;
}

// K hi, K lo, V^T hi, V^T lo, Q hi (tf32 words), then Q lo (bf16)
template <int DP>
constexpr size_t smem_bytes() {
  return 4 * kv_bytes<DP>() + static_cast<size_t>(BQ) * DP * (4 + 2) + 1024;  // + alignment
}

// byte offset of (key r, column c) in a K-major K tile: 32-column blocks of
// BK rows of 128 bytes, whose 16-byte pieces are permuted by r % 8 (wgmma's
// 128-byte swizzle)
__device__ __forceinline__ uint32_t swz_k(int r, int c) {
  return static_cast<uint32_t>((c >> 5) * BK * 128 + r * 128 +
                               ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// byte offset of (row d, k position kp) in a V^T tile: DP rows of 128 bytes
// (the BK = 32 keys), swizzled the same way
__device__ __forceinline__ uint32_t swz_v(int d, int kp) {
  return static_cast<uint32_t>(d * 128 + ((((kp >> 2) & 7) ^ (d & 7)) << 4) + ((kp & 3) << 2));
}

__device__ __forceinline__ uint4 lds4(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr));
  return x;
}
__device__ __forceinline__ void sts4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b),
               "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ uint2 lds2(uint32_t addr) {
  uint2 x;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(x.x), "=r"(x.y) : "r"(addr));
  return x;
}
__device__ __forceinline__ void sts2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b) : "memory");
}

// x rounded to bf16 (to nearest, ties to even), as the high 16 bits of a
// float32 word (finite x)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// The split of K and V, once a call: tile t of keys [32 t, 32 t + 32) of
// (batch b, kv head) becomes four images of the attention kernel's shared
// memory, K hi, K lo, V^T hi, V^T lo (kv_bytes<DP>() each), zeros past Skv
// and past D. A K image is K-major in the 128-byte swizzle (swz_k); a V^T
// image holds DP rows of the tile's keys, key r at k position tf32_kpos(r)
// (swz_v). Every attention block of the kv head then copies the images
// instead of splitting the same tiles again. Grid (T, KH, B), a tile a block.
template <int DP, bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS) split_kv_kernel(const Params p) {
  constexpr uint32_t KVB = kv_bytes<DP>();
  constexpr int LDV = DP + 1;  // a row of raw V in shared memory, padded: no bank conflicts
  __shared__ float vs[BK * LDV];
  const int t = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const float* kb = p.k + b * p.k_b + kvh * p.k_h;
  const float* vb = p.v + b * p.v_b + kvh * p.v_h;
  uint8_t* img = p.tiles + ((static_cast<size_t>(b) * p.KH + kvh) * p.T + t) * 4 * KVB;
  uint8_t *k_hi = img, *k_lo = img + KVB, *v_hi = img + 2 * KVB, *v_lo = img + 3 * KVB;
  static_assert(BK * DP / 4 % SPLIT_THREADS == 0, "every thread splits the same pieces");
  // K straight into its images, V raw into shared memory: rows read whole
#pragma unroll
  for (int j = 0; j < BK * DP / 4 / SPLIT_THREADS; ++j) {
    const int i = threadIdx.x + j * SPLIT_THREADS;
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const int key = t * BK + r;
    float x[2][4] = {};  // K, V
    if (key < p.Skv) {
      const long long ko = static_cast<long long>(key) * p.k_s + c;
      const long long vo = static_cast<long long>(key) * p.v_s + c;
      if (VEC && c < p.D) {
        const float4 a = *reinterpret_cast<const float4*>(kb + ko);
        const float4 e = *reinterpret_cast<const float4*>(vb + vo);
        x[0][0] = a.x; x[0][1] = a.y; x[0][2] = a.z; x[0][3] = a.w;
        x[1][0] = e.x; x[1][1] = e.y; x[1][2] = e.z; x[1][3] = e.w;
      } else if (!VEC) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < p.D) {
            x[0][e] = kb[ko + e];
            x[1][e] = vb[vo + e];
          }
        }
      }
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wg::split_tf32(x[0][e], hi[e], lo[e]);
      vs[r * LDV + c + e] = x[1][e];
    }
    const uint32_t off = swz_k(r, c);
    *reinterpret_cast<uint4*>(k_hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(k_lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  // V^T: lane r takes key r, so a warp writes one 128-byte row of each image
  const int r = threadIdx.x % BK, kp = wg::tf32_kpos(r);
#pragma unroll 4
  for (int d = threadIdx.x / BK; d < DP; d += SPLIT_THREADS / BK) {
    uint32_t hi, lo;
    wg::split_tf32(vs[r * LDV + d], hi, lo);
    *reinterpret_cast<uint32_t*>(v_hi + swz_v(d, kp)) = hi;
    *reinterpret_cast<uint32_t*>(v_lo + swz_v(d, kp)) = lo;
  }
}

// BYTES from global memory to shared memory at dst, 16 bytes a cp.async
template <uint32_t BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const uint8_t* src) {
  static_assert(BYTES % (16 * THREADS) == 0, "every thread copies the same number of pieces");
#pragma unroll 8
  for (uint32_t j = 0; j < BYTES / 16 / THREADS; ++j) {
    const uint32_t o = (threadIdx.x + j * THREADS) * 16;
    wg::cp_async_16(dst + o, src + o, 16);
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tf32_kernel(const Params p) {
  constexpr int NACC = DP / 2;  // accumulator registers a thread
  constexpr int KSTEPS = DP / 8;  // k8 steps of s = Q K^T
  static_assert(KG * 8 == 32, "a group of s reads one 32-column block of K");
  constexpr uint32_t KVB = kv_bytes<DP>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sKh = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  const uint32_t sKl = sKh + KVB, sVh = sKl + KVB, sVl = sVh + KVB;
  const uint32_t sQh = sVl + KVB;  // [KSTEPS][THREADS] 4 tf32 words, the order of operand a
  const uint32_t sQl = sQh + BQ * DP * 4;  // [KSTEPS][THREADS] 4 bf16, the same order

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int kvh = h / (p.H / p.KH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row_in_wg = 16 * warp + lane / 4;  // and + 8

  const float* qb = p.q + b * p.q_b + h * p.q_h;
  float* ob = p.o + b * p.o_b + h * p.o_h;
  // tile t's images: K hi + lo at 4 t KVB, V^T hi + lo after them
  const uint8_t* img = p.tiles + (static_cast<size_t>(b) * p.KH + kvh) * p.T * 4 * KVB;

  const int t_lo = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BK;
  const int t_hi = ((p.causal ? min(p.Skv, q0 + BQ) : p.Skv) + BK - 1) / BK;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};  // this thread's part of l

  if (t_lo < t_hi) {
    copy_async<2 * KVB>(sKh, img + static_cast<size_t>(t_lo) * 4 * KVB);
    wg::cp_async_commit();
    copy_async<2 * KVB>(sVh, img + (static_cast<size_t>(t_lo) * 4 + 2) * KVB);
    wg::cp_async_commit();
    // Q scaled and split, hi = tf32(q) and lo = bf16(q - hi), in the register
    // operand's order (step kk of thread tid: (row, col), (row + 8, col),
    // (row, col + 4), (row + 8, col + 4))
    const int c0 = lane % 4;
#pragma unroll 4
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_in_wg + 8 * (e & 1), col = 8 * kk + c0 + 4 * (e >> 1);
        const float x = q0 + r < p.Sq && col < p.D
                            ? qb[static_cast<long long>(q0 + r) * p.q_s + col] * p.scale
                            : 0.0f;
        hi[e] = wg::tf32_rna(x);
        lo[e] = bf16_bits(x - __uint_as_float(hi[e]));
      }
      sts4(sQh + (kk * THREADS + tid) * 16, hi[0], hi[1], hi[2], hi[3]);
      sts2(sQl + (kk * THREADS + tid) * 8, lo[0] | (lo[1] << 16), lo[2] | (lo[3] << 16));
    }
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    // ---- K(t) has landed (V(t) may still be in flight)
    wg::cp_async_wait<1>();
    wg::fence_proxy_async();
    __syncthreads();

    // ---- s = Q K^T, 64 x 32 float32, 3xTF32; Q's hi and lo for KG k steps
    // at a time, in two register sets, one group of wgmmas in flight. Group
    // g reads the 32-column block g of K hi and lo; once it is done, block g
    // of K(t + 1) is copied in, while s(t) goes on
    const bool more = t + 1 < t_hi;
    const uint8_t* k_next = img + static_cast<size_t>(t + 1) * 4 * KVB;
    const auto copy_k_block = [&](int cb) {
      copy_async<BK * 128>(sKh + cb * BK * 128, k_next + cb * BK * 128);
      copy_async<BK * 128>(sKl + cb * BK * 128, k_next + KVB + cb * BK * 128);
    };
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    uint32_t qa[2][KG][2][4];  // [set][step][hi, lo][operand word]
    wg::fence_regs(s);
#pragma unroll
    for (int g = 0; g < KSTEPS / KG; ++g) {
      uint32_t(&set)[KG][2][4] = qa[g & 1];
      if (g >= 2) {
        wg::wait<1>();  // the group that read this set (g - 2) is done
#pragma unroll
        for (int st = 0; st < KG; ++st) {
          wg::fence_regs(set[st][0]);
          wg::fence_regs(set[st][1]);
        }
        if (more) {
          __syncthreads();  // in every warp: block g - 2 of K is free
          copy_k_block(g - 2);
        }
      }
#pragma unroll
      for (int st = 0; st < KG; ++st) {
        const int i = (KG * g + st) * THREADS + tid;
        const uint4 h = lds4(sQh + i * 16);
        const uint2 w = lds2(sQl + i * 8);
        set[st][0][0] = h.x;
        set[st][0][1] = h.y;
        set[st][0][2] = h.z;
        set[st][0][3] = h.w;
        set[st][1][0] = w.x << 16;
        set[st][1][1] = w.x & 0xFFFF0000u;
        set[st][1][2] = w.y << 16;
        set[st][1][3] = w.y & 0xFFFF0000u;
      }
      wg::fence();
#pragma unroll
      for (int st = 0; st < KG; ++st) {
        const int kk = KG * g + st;
        const uint32_t off = (kk >> 2) * BK * 128 + (kk & 3) * 32;
        const uint64_t dh = wg::desc_sw128(sKh + off, 16, 1024);
        const uint64_t dl = wg::desc_sw128(sKl + off, 16, 1024);
        wg::wgmma_tf32_m64k8_rs(s, set[st][0], dh, 1);
        wg::wgmma_tf32_m64k8_rs(s, set[st][0], dl, 1);
        wg::wgmma_tf32_m64k8_rs(s, set[st][1], dh, 1);
      }
      wg::commit();
    }
    wg::wait<0>();
    wg::fence_regs(s);
#pragma unroll
    for (int set = 0; set < 2; ++set)
#pragma unroll
      for (int st = 0; st < KG; ++st) {
        wg::fence_regs(qa[set][st][0]);
        wg::fence_regs(qa[set][st][1]);
      }
    if (more) {  // the rest of K(t + 1), in flight during the softmax and P V
      __syncthreads();  // every warp's s is done
#pragma unroll
      for (int cb = (KSTEPS / KG > 2 ? KSTEPS / KG - 2 : 0); cb < KSTEPS / KG; ++cb)
        copy_k_block(cb);
      wg::cp_async_commit();
    }

    // ---- scores in log2 units, masked where the tile needs it
    const bool need_mask = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > q0) ||
                           (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i];
      x = p.softcap > 0.0f ? p.softcap * tanhf(x / p.softcap) * LOG2E : x * LOG2E;
      if (need_mask) {
        const int qpos = q0 + row_in_wg + 8 * ((i >> 1) & 1);
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        bool ok = kpos < p.Skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        x = ok ? x : NEG_INF;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a row are lanes 4g .. 4g + 3
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float pi = s[i] == NEG_INF ? 0.0f : exp2f(s[i] - mx[r]);
      s[i] = pi;
      l[r] += pi;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i >> 1) & 1];

    // ---- p as tf32 hi + lo operand words, four k8 steps: k position c holds
    // key 2c of the step, c + 4 key 2c + 1 (tf32_kpos)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      wg::split_tf32(s[4 * j + 0], ph[j][0], pl[j][0]);
      wg::split_tf32(s[4 * j + 2], ph[j][1], pl[j][1]);
      wg::split_tf32(s[4 * j + 1], ph[j][2], pl[j][2]);
      wg::split_tf32(s[4 * j + 3], ph[j][3], pl[j][3]);
    }

    // ---- V(t) has landed (K(t + 1) may still be in flight)
    if (more) {
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();

    // ---- acc += p_hi V_hi + p_lo V_hi + p_hi V_lo
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint64_t dh = wg::desc_sw128(sVh + j * 32, 16, 1024);
      const uint64_t dl = wg::desc_sw128(sVl + j * 32, 16, 1024);
      wg::wgmma_tf32_m64k8_rs(acc, ph[j], dh, 1);
      wg::wgmma_tf32_m64k8_rs(acc, pl[j], dh, 1);
      wg::wgmma_tf32_m64k8_rs(acc, ph[j], dl, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      wg::fence_regs(ph[j]);
      wg::fence_regs(pl[j]);
    }
    if (more) {  // V(t + 1), in flight during the next s
      __syncthreads();  // every warp's P V is done: the V^T tiles may be refilled
      copy_async<2 * KVB>(sVh, img + (static_cast<size_t>(t + 1) * 4 + 2) * KVB);
      wg::cp_async_commit();
    }
  }

  // ---- o = acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row_in_wg + 8 * r;
    if (qpos >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* orow = ob + static_cast<long long>(qpos) * p.o_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float x0 = acc[4 * j + 2 * r] * inv, x1 = acc[4 * j + 2 * r + 1] * inv;
      if (VEC) {
        if (col < p.D) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < p.D) orow[col] = x0;
        if (col + 1 < p.D) orow[col + 1] = x1;
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed once for each
// kernel on each device; `allowed` keeps a bit for each device done.
template <int DP, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DP, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  split_kv_kernel<DP, VEC><<<dim3(p.T, p.KH, p.B), SPLIT_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ);
  flash_fwd_tf32_kernel<DP, VEC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64, VEC>(p, stream);
  if (p.D <= 128) return launch<128, VEC>(p, stream);
  return launch<256, VEC>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int padded_d(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

}  // namespace

extern "C" {

// Bytes of the scratch that flash_fwd_f32_tc takes: the hi + lo tile images
// of K and V (4 x 32 keys x DP floats a tile).
long long flash_f32_tc_scratch_bytes(int B, int KH, int Skv, int D) {
  const long long T = (Skv + BK - 1) / BK;
  return static_cast<long long>(B) * KH * T * 4 * BK * padded_d(D) * 4;
}

// float32 q, k, v, o device pointers and a device scratch of
// flash_f32_tc_scratch_bytes(B, KH, Skv, D) bytes, 16-byte aligned; strides
// points to 12 host int64 element strides: (batch, seq, head) of q, k, v, o.
// window <= 0 and softcap <= 0 mean none. staged != 0 reads rows element
// by element (any layout runs); staged == 0 reads them in 16-byte pieces,
// which needs D and every stride multiples of 4 and every pointer 16-byte
// aligned (the caller decides: kernels/flash_attention.py::staged).
// Launches the split of K and V, then attention, on `stream`. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments the kernels do not take, among them staged == 0 on a layout
// that is not 16-byte pieces).
int flash_fwd_f32_tc(const void* q, const void* k, const void* v, void* o, void* scratch, int B,
                     int H, int KH, int Sq, int Skv, int D, const long long* strides,
                     int staged, int causal, int window, float softcap, float scale,
                     void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || D < 1 || D > 256 ||
      B > 65535 || KH > 65535 || (Sq + BQ - 1) / BQ > 65535 || !aligned16(scratch))
    return cudaErrorInvalidValue;
  bool pieces = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) pieces = pieces && strides[i] % 4 == 0;
  if (!staged && !pieces) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.B = B; p.H = H; p.KH = KH; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_b = strides[0]; p.q_s = strides[1]; p.q_h = strides[2];
  p.k_b = strides[3]; p.k_s = strides[4]; p.k_h = strides[5];
  p.v_b = strides[6]; p.v_s = strides[7]; p.v_h = strides[8];
  p.o_b = strides[9]; p.o_s = strides[10]; p.o_h = strides[11];
  p.causal = causal;
  p.window = window > 0 ? window : 0;
  p.softcap = softcap > 0.0f ? softcap : 0.0f;
  p.scale = scale;
  p.tiles = static_cast<uint8_t*>(scratch);
  p.T = (Skv + BK - 1) / BK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return staged ? dispatch_d<false>(p, s) : dispatch_d<true>(p, s);
}

const char* flash_f32_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
