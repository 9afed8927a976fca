// Kernel 2's C entry over the built-in instances (MM_DISPATCH), and the
// Philox check entry; the kernel is hmc_multistep.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_multistep.cuh"
#include "philox.cuh"

namespace {

// Philox4x32-10 words for counters (i, c1, c2, 0), i < n: the bits every
// kernel draws from, written out so that a test can hold them against the
// plain version. Used by nothing else.
__global__ void philox_fill_kernel(uint32_t* __restrict__ out, int n,
                                   uint32_t c1, uint32_t c2, uint32_t k0,
                                   uint32_t k1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const mm::U32x4 w = mm::philox4x32_10(mm::U32x4{(uint32_t)i, c1, c2, 0u},
                                        k0, k1);
  out[4 * i + 0] = w.x;
  out[4 * i + 1] = w.y;
  out[4 * i + 2] = w.z;
  out[4 * i + 3] = w.w;
}

}  // namespace

extern "C" int mm_hmc_multistep_f32(
    const void* pos, const void* logp, const void* grad, const void* eps,
    const void* params, int k_steps, int n_leapfrog, int n_chains, int dim,
    int target, int affine, uint32_t chain0, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t step0, void* pos_out,
    void* logp_out, void* grad_out, void* hist, long long hist_sk,
    long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::MultistepArgs a{pos,      logp,     grad,     eps,     params,
                            k_steps,  n_leapfrog, n_chains, chain0,
                            seed_lo,  seed_hi,  step0,    pos_out,  logp_out,
                            grad_out, hist,     hist_sk,  hist_sc, stream};
#define MM_LAUNCH(T, D) return mm::launch_multistep<T, D>(a)
  MM_DISPATCH(target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int mm_philox_fill(void* out, int n, uint32_t c1, uint32_t c2,
                              uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  philox_fill_kernel<<<mm::blocks_for(n), mm::kThreads, 0,
                       (cudaStream_t)stream>>>((uint32_t*)out, n, c1, c2, k0,
                                               k1);
  return (int)cudaGetLastError();
}
