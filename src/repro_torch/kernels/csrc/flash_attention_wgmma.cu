// Forward flash attention in bf16 on Hopper's tensor cores (sm_90a, wgmma).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:38 (_kernel,
// launched by flash_attention_kernel at :89, wrapped by kernels/ops.py:240)
// for bf16 inputs; float32 inputs go to the 3xTF32 kernel of
// flash_attention_tf32.cu. It computes what that kernel computes: for each
// (batch, head, query row), softmax(softcap(scale * q . k)) @ v over the keys
// that the causal mask, the sliding window and the true key length allow,
// with an online softmax whose scores, p, running max m, sum l and
// accumulator acc are float32, and the output acc / max(l, 1e-30) rounded
// once to bf16. A row with no allowed key writes 0. Query position i is
// aligned with key position i. GQA reads kv head h / (H / KH).
//
// Layout: q and o are [B, Sq, H, D], k and v [B, Skv, KH, D] (the model's
// layout), read through their batch, sequence and head strides with the last
// dimension contiguous. With D a multiple of 8 the rows are read in 16-byte
// pieces, so the bases must be 16-byte aligned and the strides multiples of
// 8 (the wrapper checks); any other D is staged element by element.
//
// What bounds it: 4 * D operations a (query, key) pair that the mask allows
// against q + k + v + o moved once, about 900 operations a byte at gemma-2b's
// prefill shape, so the bf16 tensor cores (989 TFLOP/s dense) bound it.
//
// Design. A block of two warpgroups (256 threads) owns BQ = 128 query rows of
// one (batch, head); each warpgroup owns a 64-row slab and keeps its float32
// accumulator (64 x DP, DP/2 registers a thread), m and l in registers. The
// head dimension is padded to DP = 64, 128 or 256 with zeros in shared
// memory. Q (128 x DP bf16) is loaded once; K and V tiles of BK = 64 keys,
// in bf16, go through a ring of two stages with cp.async, so tile t + 1 is
// in flight while tile t is multiplied. Every tile sits in shared memory in
// the 128-byte swizzle that wgmma's descriptors read: 64-column blocks of
// 128-byte rows, the 16-byte pieces of row r permuted by r % 8. Rows past Skv
// or Sq and columns past D are zero-filled there (cp.async with 0 source
// bytes), never stale: 0 x NaN is NaN in the tensor core.
//
// For each tile a warpgroup
//   - computes s = Q K^T with bf16 x bf16 m64n64k16 wgmmas from shared memory
//     into float32 (exact products; scale applied after, in float32);
//   - soft-caps with tanhf, masks (only on tiles that cross the causal
//     diagonal, the window edge or Skv), and updates m, l, acc in the log2
//     domain (log2(e) folded into the scale, exp2f);
//   - splits p into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and issues two
//     register-A m64nDPk16 wgmmas against the same bf16 V tile into one
//     float32 accumulator: about 16 bits of p, for 1.5 times the tensor work
//     of a single rounding (which would not meet the float32-based bars at
//     outputs near 0).
// The KV loop of each warpgroup starts at its window's first tile and stops
// at its causal bound; the block loads the union of its two warpgroups'
// tiles. Blocks run heaviest query tiles first (blockIdx.z counts down).
// Shared memory is 64 KB of Q and 2 x 64 KB of K/V at DP = 256 (193 KB
// with alignment), so one block runs on an SM.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 128;  // query rows a block
constexpr int WG_ROWS = 64;  // query rows a warpgroup
constexpr int BK = 64;  // keys a tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int B, H, KH, Sq, Skv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int causal;
  int window;     // 0: no window
  float softcap;  // 0: no softcap
  float scale;
};

template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * DP * 2;
}

template <int DP>
constexpr size_t smem_bytes() {
  return tile_bytes<DP>(BQ) + STAGES * 2 * tile_bytes<DP>(BK) + 1024;  // + alignment
}

// byte offset of element (r, c) in a swizzled tile of `rows` rows: 64-column
// blocks one after the other, each a run of 128-byte rows whose 16-byte
// pieces are permuted by r % 8 (the layout of wgmma's 128-byte swizzle)
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return static_cast<uint32_t>((c >> 6) * rows * 128 + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// rows [row0, row0 + ROWS) x [0, DP) of a [.., S, .., D] bf16 tensor into a
// swizzled tile at shared address dst; zeros past S and past D
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int S, int D) {
  if constexpr (VEC) {
    constexpr int PIECES = ROWS * DP / 8;
    static_assert(PIECES % THREADS == 0, "every thread copies the same number of pieces");
#pragma unroll
    for (int j = 0; j < PIECES / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const int s = row0 + r;
      const bool ok = s < S && c < D;
      const __nv_bfloat16* src = ok ? base + static_cast<long long>(s) * row_stride + c : base;
      wg::cp_async_16(dst + swz(ROWS, r, c), src, ok ? 16 : 0);
    }
  } else {
    const uint16_t* b16 = reinterpret_cast<const uint16_t*>(base);
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const int s = row0 + r;
      uint16_t x = 0;
      if (s < S && c < D) x = b16[static_cast<long long>(s) * row_stride + c];
      wg::st_shared_u16(dst + swz(ROWS, r, c), x);
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma_kernel(const Params p) {
  constexpr int NACC = DP / 2;  // accumulator registers a thread
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  const uint32_t sKV = sQ + tile_bytes<DP>(BQ);  // stage st: K at sKV + st * 2 * KVB, V after
  constexpr uint32_t KVB = tile_bytes<DP>(BK);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int kvh = h / (p.H / p.KH);
  const int wgi = threadIdx.x / 128;  // warpgroup
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qa = q0 + wgi * WG_ROWS;  // first row of this warpgroup
  const int row_in_wg = 16 * warp + lane / 4;  // and + 8

  const __nv_bfloat16* qb = p.q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kb = p.k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + kvh * p.v_h;
  __nv_bfloat16* ob = p.o + b * p.o_b + h * p.o_h;

  // KV tiles [lo, hi) that rows [first, last] need
  const auto t_lo_of = [&](int first) {
    return (p.window > 0 ? max(0, first - p.window + 1) : 0) / BK;
  };
  const auto t_hi_of = [&](int last) {
    return ((p.causal ? min(p.Skv, last + 1) : p.Skv) + BK - 1) / BK;
  };
  const int t_lo = t_lo_of(q0), t_hi = t_hi_of(q0 + BQ - 1);
  const int w_lo = t_lo_of(qa), w_hi = t_hi_of(qa + WG_ROWS - 1);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};  // this thread's part of l
  const float c2 = p.scale * LOG2E;

  if (t_lo < t_hi) {
    load_tile<DP, BQ, VEC>(sQ, qb, p.q_s, q0, p.Sq, p.D);
    load_tile<DP, BK, VEC>(sKV, kb, p.k_s, t_lo * BK, p.Skv, p.D);
    load_tile<DP, BK, VEC>(sKV + KVB, vb, p.v_s, t_lo * BK, p.Skv, p.D);
    wg::cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t sK = sKV + ((t - t_lo) & 1) * 2 * KVB, sV = sK + KVB;
    if (t + 1 < t_hi) {  // the other stage was released at the end of tile t - 1
      const uint32_t nK = sKV + ((t + 1 - t_lo) & 1) * 2 * KVB;
      load_tile<DP, BK, VEC>(nK, kb, p.k_s, (t + 1) * BK, p.Skv, p.D);
      load_tile<DP, BK, VEC>(nK + KVB, vb, p.v_s, (t + 1) * BK, p.Skv, p.D);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();

    if (t >= w_lo && t < w_hi) {  // uniform in the warpgroup
      const int k0 = t * BK;

      // ---- s = Q K^T, 64 x 64 float32
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wg::fence_regs(s);
      wg::fence();
#pragma unroll
      for (int cb = 0; cb < DP / 64; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = wg::desc_sw128(
              sQ + cb * tile_bytes<64>(BQ) + wgi * WG_ROWS * 128 + kk * 32, 16, 1024);
          const uint64_t db = wg::desc_sw128(sK + cb * tile_bytes<64>(BK) + kk * 32, 16, 1024);
          wg::wgmma_m64n64k16_ss(s, da, db, 1);
        }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(s);

      // ---- scores in log2 units, masked where the tile needs it
      const bool need_mask = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > qa) ||
                             (p.window > 0 && qa + WG_ROWS - 1 - k0 >= p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i];
        if (p.softcap > 0.0f) {
          x = p.softcap * tanhf(x * p.scale / p.softcap) * LOG2E;
        } else {
          x *= c2;
        }
        if (need_mask) {
          const int qpos = qa + row_in_wg + 8 * ((i >> 1) & 1);
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
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float pi = s[i] == NEG_INF ? 0.0f : exp2f(s[i] - mx[r]);
        s[i] = pi;
        l[r] += pi;
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i >> 1) & 1];

      // ---- p as bf16 hi + lo register fragments, four k16 steps of 16 keys
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = bf16x2_bits(hi);
          pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(s[i] - hf.x, s[i + 1] - hf.y));
        }

      // ---- acc += p_hi V + p_lo V
      wg::fence_regs(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 16 kk .. 16 kk + 15: two 8-key groups 1024 bytes apart, 64-column
        // blocks of V one tile_bytes<64>(BK) apart
        const uint64_t dv = wg::desc_sw128(sV + kk * 16 * 128, tile_bytes<64>(BK), 1024);
        wg::wgmma_m64k16_rs(acc, ph[kk], dv, 1);
        wg::wgmma_m64k16_rs(acc, pl[kk], dv, 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::fence_regs(ph[kk]);
        wg::fence_regs(pl[kk]);
      }
    }
    __syncthreads();  // this stage may be refilled
  }

  // ---- o = acc / max(l, 1e-30) in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + row_in_wg + 8 * r;
    if (qpos >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * p.o_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float x0 = acc[4 * j + 2 * r] * inv, x1 = acc[4 * j + 2 * r + 1] * inv;
      if (VEC) {
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < p.D) orow[col] = __float2bfloat16(x0);
        if (col + 1 < p.D) orow[col + 1] = __float2bfloat16(x1);
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
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(p.H, p.B, (p.Sq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<DP, VEC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64, VEC>(p, stream);
  if (p.D <= 128) return launch<128, VEC>(p, stream);
  return launch<256, VEC>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// bf16 q, k, v, o device pointers; strides points to 12 host int64 element
// strides: (batch, seq, head) of q, k, v, o. window <= 0 and softcap <= 0
// mean none. staged != 0 reads rows element by element (any layout runs);
// staged == 0 reads them in 16-byte pieces, which needs D and every stride
// multiples of 8 and every pointer 16-byte aligned (the caller decides:
// kernels/flash_attention.py::staged). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take,
// among them staged == 0 on a layout that is not 16-byte pieces).
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
                   int Sq, int Skv, int D, const long long* strides, int staged, int causal,
                   int window, float softcap, float scale, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || D < 1 || D > 256 ||
      B > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  bool pieces = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) pieces = pieces && strides[i] % 8 == 0;
  if (!staged && !pieces) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B; p.H = H; p.KH = KH; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_b = strides[0]; p.q_s = strides[1]; p.q_h = strides[2];
  p.k_b = strides[3]; p.k_s = strides[4]; p.k_h = strides[5];
  p.v_b = strides[6]; p.v_s = strides[7]; p.v_h = strides[8];
  p.o_b = strides[9]; p.o_s = strides[10]; p.o_h = strides[11];
  p.causal = causal;
  p.window = window > 0 ? window : 0;
  p.softcap = softcap > 0.0f ? softcap : 0.0f;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return staged ? dispatch_d<false>(p, s) : dispatch_d<true>(p, s);
}

const char* flash_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
