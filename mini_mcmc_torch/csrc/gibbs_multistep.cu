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
// Draws: one word stream per (chain0 + c, step0 + k) under the run's
// 64-bit key (philox.cuh:step_words), the conditional's words<D>() words
// for the whole sweep, so the plain twin (ops/kernels/gibbs_full.py)
// reproduces them and the cube depends neither on K nor on the grid.
//
// What bounds it on the H100: issue, in one dependent chain per thread.
// One thread per chain, the state in registers for all K sweeps; 65,536
// chains fill four warps a scheduler, and no more exist. A mixture sweep
// is one Philox-10 evaluation (three words), a Box-Muller transform, two
// expf, three divisions and the selects, against 8 bytes of history.
// Evaluating sweep k + 1's draws beside sweep k's conditionals (a one-step
// software pipeline) measured no faster on the H100, so each sweep draws
// its own.
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
  constexpr int kWords = C::template words<D>();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const C cond(params);
  const uint32_t chain = chain0 + (uint32_t)c;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = pos[c * D + d];
  float* row = hist != nullptr ? hist + (long long)c * hist_sc : nullptr;

  for (int k = 0; k < k_steps; ++k) {
    uint32_t w[4 * mm::stream_evals<kWords>()];
    mm::step_words<kWords>(chain, step0 + (uint32_t)k, k0, k1, w);
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = cond.template sample<D>(i, x, w);
    if (row != nullptr) {
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[d];
      row += hist_sk;
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
