// The device wave loop's compaction (repro_torch.core.abc.compact_accepted)
// on the card: the accepted rows of a wave, in stream order, into the next
// free rows of the loop's accept buffer.
//
// Replaces no TPU kernel: `repro` compacts with a cumsum and a scatter in
// jnp (src/repro/core/abc.py, compact_accepted), which XLA fuses on the TPU.
// The port's PyTorch version of those lines (still its path on the CPU)
// made eleven launches a wave and wrote every one of the wave's B rows:
// the rejected ones into one spare row, so 9 * B element writes went to a
// few addresses (282 us a call at B = 1,000,000 on an H100). About 12 rows
// of a million are accepted, and a gated wave accepts none.
//
// What bounds it: reading the accept mask, B bytes (1 MB at B = 1,000,000;
// ~0.3 us at 3.35 TB/s, less from L2, where the compare that made the mask
// left it), plus p + 1 floats read and written for each accepted row. The
// launch itself (a few us) is larger than both, and on an H100 the kernel
// takes ~7 us at B = 1,000,000 (launch and look-back latency, not bytes).
// So the design is one launch that reads the mask once, and touches theta
// and dist only at accepted rows:
//
//   * a single-pass ordered stream compaction with decoupled look-back (the
//     pattern of cub's DeviceSelect::Flagged): each block takes a tile of
//     TILE flags, 16 a thread as one 16-byte load of the bool mask, counts
//     them with popc, scans the counts within the block, publishes the
//     tile's aggregate and looks back over its predecessors' status words
//     (a warp reads 32 of them at a time) for its exclusive prefix;
//   * tile order comes from an atomic ticket, not from blockIdx, so a tile
//     waits only on tiles whose blocks have started, and the look-back
//     cannot deadlock at any batch;
//   * accepted row r of the wave (r in stream order) goes to buffer row
//     fill + r while that is below capacity; later ones are dropped, and
//     rejected rows are never touched (the spare row is not written). A
//     warp copies one row at a time, a lane a parameter;
//   * the tile with the last ticket knows the total and writes
//     new_fill = fill + accepted, unclamped;
//   * the status words (a ticket, a count of finished tiles, a word a tile)
//     are all zero when a launch starts, and the launch leaves them so:
//     each tile counts itself finished once its look-back is over, and the
//     tile that finishes last zeroes the words. So no memset launch is
//     needed, no tag can wrap around, and no host state says which words a
//     launch may use: a CUDA graph can replay the launch.
//
// It does no arithmetic on values: rows and distances are copied as bits.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int FLAGS_PER_THREAD = 16;  // one 16-byte load of the bool mask
constexpr int TILE = THREADS * FLAGS_PER_THREAD;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// A status word: 0 until published, then FLAG_AGGREGATE | the tile's count
// or FLAG_PREFIX | the accepted rows of the tiles up to it, inclusive.
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;
constexpr unsigned long long VALUE = 0xFFFFFFFFull;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// 4 bits: which of the word's 4 bytes are not 0
__device__ __forceinline__ unsigned byte_flags(unsigned word) {
  const unsigned t = __vcmpne4(word, 0u) & 0x01010101u;
  return (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xFu;
}

// words: [2 + gridDim.x] (the ticket, the finished tiles, then a status a
// tile), all 0 at the launch and again at its end
__global__ void __launch_bounds__(THREADS)
abc_compact_kernel(const float* __restrict__ theta, const float* __restrict__ dist,
                   const unsigned char* __restrict__ accept, long long batch, int p,
                   const long long* __restrict__ fill, long long capacity,
                   float* __restrict__ th_buf, float* __restrict__ d_buf,
                   long long* __restrict__ new_fill, unsigned long long* words) {
  __shared__ int s_tile;
  __shared__ int s_warp[WARPS];
  __shared__ long long s_before;
  __shared__ bool s_last;
  __shared__ int s_rows[TILE];  // the tile's accepted rows, in order

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(words, 1ull));
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * TILE;

  // the thread's 16 flags, bit k for row base + 16 tid + k
  const long long first = base + static_cast<long long>(tid) * FLAGS_PER_THREAD;
  unsigned mask = 0;
  if (first + FLAGS_PER_THREAD <= batch &&
      (reinterpret_cast<uintptr_t>(accept) & 15u) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(accept + first);
    mask = byte_flags(v.x) | (byte_flags(v.y) << 4) | (byte_flags(v.z) << 8) |
           (byte_flags(v.w) << 12);
  } else {
    for (int k = 0; k < FLAGS_PER_THREAD && first + k < batch; ++k) {
      if (accept[first + k]) mask |= 1u << k;
    }
  }
  const int count = __popc(mask);

  // exclusive scan of the counts within the block
  int incl = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? s_warp[lane] : 0;
    for (int d = 1; d < WARPS; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < WARPS) s_warp[lane] = w;
  }
  __syncthreads();
  const int in_tile = (warp ? s_warp[warp - 1] : 0) + incl - count;
  const int aggregate = s_warp[WARPS - 1];
  unsigned long long* status = words + 2;

  // the accepted rows of the tiles before this one: look back
  if (warp == 0) {
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) {
        Status(status[0]).store(FLAG_PREFIX | aggregate, cuda::std::memory_order_release);
      }
    } else {
      if (lane == 0) {
        Status(status[tile]).store(FLAG_AGGREGATE | aggregate, cuda::std::memory_order_release);
      }
      for (int last = tile - 1;; last -= 32) {
        // lane i reads tile last - i; before tile 0 reads as a prefix of 0
        const int at = last - lane;
        unsigned long long s = at >= 0 ? 0ull : FLAG_PREFIX;
        while (true) {
          if (at >= 0) s = Status(status[at]).load(cuda::std::memory_order_acquire);
          if (!__any_sync(FULL, s == 0ull)) break;
          __nanosleep(32);
        }
        // the nearest prefix ends the look-back: add the words up to it
        const unsigned prefixes = __ballot_sync(FULL, (s & ~VALUE) == FLAG_PREFIX);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        long long v = lane <= stop ? static_cast<long long>(s & VALUE) : 0;
        for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
        before += __shfl_sync(FULL, v, 0);
        if (prefixes) break;
      }
      if (lane == 0) {
        Status(status[tile]).store(
            FLAG_PREFIX | static_cast<unsigned long long>(before + aggregate),
            cuda::std::memory_order_release);
      }
    }
    if (lane == 0) {
      s_before = before;
      // every status store of this tile came before, in this thread: the
      // tile that counts itself last sees them all, and every other tile's
      // look-back is over, so it may zero the words for the next launch
      s_last = Status(words[1]).fetch_add(1ull, cuda::std::memory_order_acq_rel) ==
               gridDim.x - 1;
    }
  }
  __syncthreads();
  if (s_last) {
    for (unsigned i = tid; i < gridDim.x + 2; i += THREADS) {
      Status(words[i]).store(0ull, cuda::std::memory_order_relaxed);
    }
  }
  const long long before = s_before;
  if (static_cast<unsigned>(tile) == gridDim.x - 1 && tid == 0) {
    *new_fill = *fill + before + aggregate;
  }
  if (aggregate == 0) return;

  // the tile's accepted rows in order, then a warp a row, a lane a parameter
  int at = in_tile;
  for (unsigned m = mask; m; m &= m - 1) s_rows[at++] = tid * FLAGS_PER_THREAD + __ffs(m) - 1;
  __syncthreads();
  const long long dst0 = *fill + before;
  for (int r = warp; r < aggregate; r += WARPS) {
    const long long dst = dst0 + r;
    if (dst >= capacity) break;  // every later row lies past it too
    const long long src = base + s_rows[r];
    for (int j = lane; j < p; j += 32) th_buf[dst * p + j] = theta[src * p + j];
    if (lane == 0) d_buf[dst] = dist[src];
  }
}

}  // namespace

extern "C" {

int abc_compact_tile() { return TILE; }

// theta [batch, p] f32, dist [batch] f32, accept [batch] bool, fill [1] i64,
// th_buf [capacity + 1, p] f32, d_buf [capacity + 1] f32, new_fill [1] i64,
// all on one device; words [2 + tiles] u64, all 0, which the launch leaves
// so. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments it does not take).
int abc_compact(const void* theta, const void* dist, const void* accept, long long batch, int p,
                const void* fill, long long capacity, void* th_buf, void* d_buf, void* new_fill,
                void* words, void* stream) {
  if (batch <= 0 || batch > 0x7FFFFFFFLL || p <= 0 || capacity < 0) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (batch + TILE - 1) / TILE;
  abc_compact_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(dist),
      static_cast<const unsigned char*>(accept), batch, p, static_cast<const long long*>(fill),
      capacity, static_cast<float*>(th_buf), static_cast<float*>(d_buf),
      static_cast<long long*>(new_fill), static_cast<unsigned long long*>(words));
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
