// Kernel 6: K fused Gibbs sweeps per launch.
//
// The kernel template and its launch, shared by the built-in library
// (gibbs_multistep.cu) and the per-form libraries of user conditionals
// (ops/kernels/user_density.py).
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"

namespace mm {

template <class C, int D>
__global__ void __launch_bounds__(kThreads)
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
    uint32_t w[4 * stream_evals<kWords>()];
    step_words<kWords>(chain, step0 + (uint32_t)k, k0, k1, w);
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

struct GibbsArgs {
  const void* pos;
  const void* params;
  int k_steps, n_chains;
  uint32_t chain0, k0, k1, step0;
  void* pos_out;
  void* hist;
  long long hist_sk, hist_sc;
  void* stream;
};

template <class C, int D>
int launch_gibbs(const GibbsArgs& a) {
  gibbs_multistep_kernel<C, D>
      <<<blocks_for(a.n_chains), kThreads, 0, (cudaStream_t)a.stream>>>(
          (const float*)a.pos, (const float*)a.params, a.k_steps,
          a.n_chains, a.chain0, a.k0, a.k1, a.step0, (float*)a.pos_out,
          (float*)a.hist, a.hist_sk, a.hist_sc);
  return (int)cudaGetLastError();
}

}  // namespace mm
