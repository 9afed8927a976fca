// Kernel 6: K fused Gibbs sweeps per launch.
//
// Replaces mini_mcmc_tpu/ops/pallas/gibbs_full.py:make_pallas_gibbs_multistep
// (and its K = 1 form without history). Per chain and sweep, coordinate
// i = 0..D-1 in order is drawn from its full conditional given the state
// already updated at coordinates < i (gibbs_full.py:85-95, reference
// gibbs.rs:95-99), by the conditional functor (conditionals.cuh); the
// sweep is unrolled over D. Each post-sweep state goes to hist[k, c, :]
// through the runner's strides, as in Kernels 2 and 5; a null `hist`
// writes no history. float32 states only, as in the JAX package.
//
// Draws: Philox at (chain0 + c, step0 + k, draw i, 0) for coordinate i
// under the run's 64-bit key (philox.cuh), so the plain twin
// (ops/kernels/gibbs_full.py) reproduces them and the cube depends neither
// on K nor on the grid.
//
// What bounds it on the H100: one thread per chain, the state in
// registers for all K sweeps. For the mixture a sweep is two Philox-10
// evaluations, a Box-Muller transform, two expf, a division and the
// selects, ~300 lane instructions, against 8 bytes of history: issue
// bounds it, not bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conditionals.cuh"
#include "hmc_common.cuh"
#include "philox.cuh"

namespace {

template <class C, int D>
__global__ void __launch_bounds__(mm::kThreads)
    gibbs_multistep_kernel(const float* __restrict__ pos,
                           const float* __restrict__ params, int k_steps,
                           int n_chains, uint32_t chain0, uint32_t k0,
                           uint32_t k1, uint32_t step0,
                           float* __restrict__ pos_out,
                           float* __restrict__ hist, long long hist_sk,
                           long long hist_sc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const C cond(params);
  const uint32_t chain = chain0 + (uint32_t)c;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = pos[c * D + d];

  for (int k = 0; k < k_steps; ++k) {
    const uint32_t step = step0 + (uint32_t)k;
#pragma unroll
    for (int i = 0; i < D; ++i)
      x[i] = cond.template sample<D>(i, x, chain, step, k0, k1);
    if (hist != nullptr) {
      float* row = hist + (long long)k * hist_sk + (long long)c * hist_sc;
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[d];
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) pos_out[c * D + d] = x[d];
}

}  // namespace

// The instantiated (conditional, D) are those of GIBBS_INSTANCES in
// ops/kernels/_build.py; any other returns cudaErrorInvalidValue.
extern "C" int mm_gibbs_multistep(const void* pos, const void* params,
                                  int k_steps, int n_chains, int dim,
                                  int conditional, uint32_t chain0,
                                  uint32_t seed_lo, uint32_t seed_hi,
                                  uint32_t step0, void* pos_out, void* hist,
                                  long long hist_sk, long long hist_sc,
                                  void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (conditional == mm::kGaussianMixture && dim == 2) {
    gibbs_multistep_kernel<mm::GaussianMixture, 2>
        <<<mm::blocks_for(n_chains), mm::kThreads, 0,
           (cudaStream_t)stream>>>(
            (const float*)pos, (const float*)params, k_steps, n_chains,
            chain0, seed_lo, seed_hi, step0, (float*)pos_out, (float*)hist,
            hist_sk, hist_sc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
