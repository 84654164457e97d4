// Forward flash attention for Hopper (sm_90a), CUDA cores in float32: the
// float32 route until the 3xTF32 tensor-core kernel
// (src/repro_torch/kernels/csrc/flash_attention_tf32.cu) replaced it. Kept
// here so that experiments/flash_f32_cuda_core.py and chip_smoke.py can time
// it in turns with that kernel; the port does not call it.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:38 (_kernel,
// launched by flash_attention_kernel at :89, wrapped by kernels/ops.py:240)
// for float32 inputs. It computes what that kernel computes: for each
// (batch, head, query row), softmax(softcap(scale * q . k)) @ v over the keys
// that the causal mask, the sliding window and the true key length allow,
// with an online softmax whose running max m, sum l and accumulator acc are
// float32, and the output acc / max(l, 1e-30). A row with no allowed key
// writes 0. Query position i is aligned with key position i (no offset).
// GQA reads kv head h / (H / KH).
//
// Layout: q and o are [B, Sq, H, D], k and v [B, Skv, KH, D] (the model's
// layout), read through their batch, sequence and head strides; the last
// dimension must be contiguous. Ragged lengths are masked here, so the
// wrapper pads and copies nothing.
//
// Design. One block of 256 threads (8 warps) owns a tile of BQ = 64 query
// rows of one (batch, head); warp w owns rows 8w..8w+7 for the whole sweep,
// and its (m, l) and its 8 x D accumulator stay in registers (D/32 columns a
// lane, strided by 32 so that stores are coalesced). The scaled query tile
// is staged in shared memory once; K and V tiles of BK = 64 keys are staged
// one after the other. For each K/V tile a lane computes the scores of its
// 8 rows against keys lane and lane + 32 from float4 reads (the query reads
// are warp broadcasts), the warp reduces max and sum with shuffles, and
// writes p to its own rows of a shared tile that the same warp then
// multiplies into V. The KV loop starts at the window's first tile and stops
// at the causal bound. The heaviest (last) query tiles are scheduled first.
//
// What bounds it: under the causal mask the work is 4 * D operations a
// (query, key) pair against q + k + v + o read or written once, about 450
// operations a byte at 4 x 2048 x 8 heads, D = 256 in float32; so it is bound
// by arithmetic. This kernel does that arithmetic on the CUDA cores in
// float32 (67 TFLOP/s on the H100 SXM): float32 products on the tensor cores
// would be TF32, which keeps 10 bits of mantissa and would not meet the
// float32 bar. Shared memory is 215,040 bytes at D = 256, so one block runs
// on an SM at a time and global loads are not overlapped with compute.
// Built without --fmad=false: a fused multiply-add only rounds less, and the
// plain version is held at a tolerance, not bitwise.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;  // rows a warp
constexpr int PAD = 4;         // floats of padding on a Q / K row (bank spread, float4 aligned)
constexpr float NEG_INF = -1e30f;

static_assert(BK == 64, "a lane scores keys lane and lane + 32");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, Sq, Skv, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int causal;
  int window;     // 0: no window
  float softcap;  // 0: no softcap
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (DMAX + PAD) +
                          static_cast<size_t>(BK) * (DMAX + PAD) +
                          static_cast<size_t>(BK) * DMAX + static_cast<size_t>(BQ) * BK);
}

// rows x D of a [.., S, .., D] tensor into a float tile [rows][ld]; zero
// outside the sequence and beyond D
template <class T, int DMAX>
__device__ __forceinline__ void stage(float* tile, int ld, const T* base, long long row_stride,
                                      int row0, int rows, int S, int D, float mul) {
  for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    const int s = row0 + r;
    float x = 0.0f;
    if (s < S && c < D) x = to_f(base[static_cast<long long>(s) * row_stride + c]) * mul;
    tile[r * ld + c] = x;
  }
}

template <class T, int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(Params p) {
  constexpr int NC = DMAX / 32;  // output columns a lane
  constexpr int LDQ = DMAX + PAD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BQ][LDQ], scaled
  float* Ks = Qs + BQ * LDQ;       // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;       // [BK][DMAX]
  float* Ps = Vs + BK * DMAX;      // [BQ][BK]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_b + kvh * p.k_h;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_b + kvh * p.v_h;
  T* ob = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;

  stage<T, DMAX>(Qs, LDQ, qb, p.q_s, q0, BQ, p.Sq, p.D, p.scale);

  // KV range of this tile: [lo, hi)
  int hi = p.Skv;
  if (p.causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }
  const int row0 = warp * ROWS;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, DMAX>(Ks, LDQ, kb, p.k_s, k0, BK, p.Skv, p.D, 1.0f);
    stage<T, DMAX>(Vs, DMAX, vb, p.v_s, k0, BK, p.Skv, p.D, 1.0f);
    __syncthreads();

    // scores of rows row0.. against keys k0 + lane and k0 + lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
    const float4* k_lo = reinterpret_cast<const float4*>(Ks + lane * LDQ);
    const float4* k_hi = reinterpret_cast<const float4*>(Ks + (lane + 32) * LDQ);
#pragma unroll 4
    for (int d4 = 0; d4 < DMAX / 4; ++d4) {
      const float4 ka = k_lo[d4], kc = k_hi[d4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(Qs + (row0 + r) * LDQ)[d4];
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kc.x + qv.y * kc.y + qv.z * kc.z + qv.w * kc.w;
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + row0 + r;
      bool ok[2];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        float x = s[r][j];
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        ok[j] = kpos < p.Skv;
        if (p.causal) ok[j] = ok[j] && kpos <= qpos;
        if (p.window > 0) ok[j] = ok[j] && qpos - kpos < p.window;
        x = ok[j] ? x : NEG_INF;
        s[r][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pj = ok[j] ? expf(s[r][j] - m_new) : 0.0f;
        Ps[(row0 + r) * BK + lane + 32 * j] = pj;
        psum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc[rows of this warp] += P[rows][BK] @ V[BK][columns of this lane]
#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[jj][c] = Vs[(4 * j4 + jj) * DMAX + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pv = reinterpret_cast<const float4*>(Ps + (row0 + r) * BK)[j4];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += pv.x * vv[0][c] + pv.y * vv[1][c] + pv.z * vv[2][c] + pv.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) ob[static_cast<long long>(qpos) * p.o_s + col] = from_f<T>(acc[r][c] * inv);
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed once for each
// kernel on each device; `allowed` keeps a bit for each device done.
template <class T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> allowed{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(allowed.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      allowed.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

extern "C" {

// float32 q, k, v, o device pointers; strides points to 12 host int64
// element strides: (batch, seq, head) of q, k, v, o. window <= 0 and
// softcap <= 0 mean none. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
                  int Sq, int Skv, int D, const long long* strides, int causal, int window,
                  float softcap, float scale, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || D < 1 || D > 256 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.KH = KH; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_b = strides[0]; p.q_s = strides[1]; p.q_h = strides[2];
  p.k_b = strides[3]; p.k_s = strides[4]; p.k_h = strides[5];
  p.v_b = strides[6]; p.v_s = strides[7]; p.v_h = strides[8];
  p.o_b = strides[9]; p.o_s = strides[10]; p.o_h = strides[11];
  p.causal = causal;
  p.window = window > 0 ? window : 0;
  p.softcap = softcap > 0.0f ? softcap : 0.0f;
  p.scale = scale;
  return dispatch_d<float>(p, static_cast<cudaStream_t>(stream));
}

const char* flash_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
