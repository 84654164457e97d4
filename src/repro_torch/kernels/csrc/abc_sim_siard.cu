// The fused ABC simulation kernel (abc_sim.cuh, where its design and what
// bounds it are described) for the paper's SIARD model (siard.cuh): the
// exports abc_sim_distance_siard and abc_sim_wave_siard, and the test
// entries of the kernel's RNG. One translation unit a model,
// abc_sim_<model>.cu, so that nvcc builds the models side by side.
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel) for
// SIARD, with the counter-hash RNG of src/repro/kernels/rng.py:32-79.

#include "abc_sim.cuh"
#include "siard.cuh"

ABC_SIM_EXPORTS(siard, Siard)

namespace {

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

}  // extern "C"
