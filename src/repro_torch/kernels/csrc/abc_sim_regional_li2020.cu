// The region axis of the fused ABC simulation kernel for Li et al. 2020's
// cities (li2020.cuh): the tile route alone (abc_sim_regional_tile.cuh, a
// tile of samples a block, where its design is described), the exports
// abc_sim_regional_{distance,wave}_tile_li2020. The thread and warp routes
// take neither inflow nor outflow rows, populations a region nor region
// constants, so this unit does not build them. abc_sim_li2020_math_mismatches
// holds the branch-free square root of the tau-leap (root_checked) and
// quotient of the struct (div_checked) to sqrtf and `/` on the card.
//
// No TPU kernel computes this model; it replaces none.

#include "abc_sim_regional_tile.cuh"
#include "li2020.cuh"

ABC_SIM_REGIONAL_LAYOUT_EXPORTS(li2020, Li2020)
ABC_SIM_REGIONAL_TILE_EXPORTS(li2020, Li2020)

namespace {

// counts[0]: the float bit patterns (all 2^32) whose root_checked, where it
// takes the fast path, differs from sqrtf; counts[3]: those it takes it for.
__global__ void root_check_kernel(unsigned long long* counts) {
  unsigned long long bad = 0, fast = 0;
  const unsigned long long step = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32); i += step) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    bool slow = false;
    const float y = root_checked(x, slow);
    if (!slow) {
      ++fast;
      bad += __float_as_uint(y) != __float_as_uint(sqrtf(x));
    }
  }
  atomicAdd(counts, bad);
  atomicAdd(counts + 3, fast);
}

// counts[1]: of `pairs` hashed (a, b), exponents 60 to 194 around
// div_checked's sure range and one a in 16 a zero, those whose quotient,
// where div_checked takes the fast path, differs from a / b; counts[2]:
// those it takes it for.
__global__ void div_check_kernel(unsigned long long pairs, unsigned long long* counts) {
  unsigned long long bad = 0, fast = 0;
  const unsigned long long step = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < pairs; i += step) {
    const unsigned h1 = rng::fmix32(static_cast<unsigned>(i) ^ static_cast<unsigned>(i >> 32) * rng::P1);
    const unsigned h2 = rng::fmix32(h1 ^ rng::X1), h3 = rng::fmix32(h2 ^ rng::P2);
    unsigned ua = (h1 & 0x807fffffu) | ((60u + h3 % 135u) << 23);
    const unsigned ub = (h2 & 0x807fffffu) | ((60u + (h3 >> 8) % 135u) << 23);
    if (((h3 >> 24) & 15u) == 0u) ua &= 0x80000000u;
    const float a = __uint_as_float(ua), b = __uint_as_float(ub);
    bool slow = false;
    const float q = div_checked(a, b, slow);
    if (!slow) {
      ++fast;
      bad += __float_as_uint(q) != __float_as_uint(a / b);
    }
  }
  atomicAdd(counts + 1, bad);
  atomicAdd(counts + 2, fast);
}

}  // namespace

// The branch-free pieces of this unit against the CUDA math they stand for,
// on the card: counts (4 unsigned 64-bit words on the device, zeroed by the
// caller) as the check kernels above fill them. `pairs` of quotients.
extern "C" int abc_sim_li2020_math_mismatches(unsigned long long pairs, void* counts,
                                              void* stream) {
  auto* c = static_cast<unsigned long long*>(counts);
  const auto st = static_cast<cudaStream_t>(stream);
  root_check_kernel<<<1024, 256, 0, st>>>(c);
  div_check_kernel<<<1024, 256, 0, st>>>(pairs, c);
  return cudaGetLastError();
}
