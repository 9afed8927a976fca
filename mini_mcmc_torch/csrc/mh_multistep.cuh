// Kernel 5: K fused Metropolis-Hastings steps per launch.
//
// The kernel template and its launch, shared by the built-in library
// (mh_multistep.cu) and the per-form libraries of user densities and
// proposals (ops/kernels/user_density.py, the value-only table).
//
// Replaces mini_mcmc_tpu/ops/pallas/mh_full.py:make_pallas_mh_multistep
// (and its K = 1 form without history). For each of the K steps, per
// chain: a symmetric proposal drawn by the proposal functor
// (proposals.cuh), the target's logp there (targets.cuh), and the strict
// accept `(lp' - lp) > logf(u)` (mh_full.py:91-96, reference
// metropolis_hastings.rs:309-313) with true selects: a -inf or NaN
// proposal compares false and leaves the kept state as it was. The kept
// position goes to hist[k, c, :] through the runner's strides, as in
// Kernel 2; a null `hist` writes no history.
//
// Positions are float or int32_t (discrete targets); the cached logp is
// float either way (mh_full.py:22-23). Under a transform (transform=, the
// JAX package's wrapped logp_dc, transforms.py:387-446) the walk runs in
// the unconstrained y and the density is targets.cuh:Transformed<T, D>,
// T::logp(g(y)) + log|g'(y)|, the functor Kernels 1-4 run; the kernel
// needs its value only. The int32 instance takes no transform.
//
// Draws: one word stream per (chain0 + c, step0 + k) under the run's
// 64-bit key (philox.cuh:step_words): the proposal's words<D>() words,
// then the accept uniform's. The plain twin
// (ops/kernels/mh_full.py) reproduces them, and the cube depends neither
// on K nor on the grid.
//
// What bounds it on the H100: issue, in one dependent chain per thread.
// One thread per chain, position and logp in registers for all K steps;
// 65,536 chains fill 496 threads an SM, four warps a scheduler, and no
// more exist. A Gaussian2D step is one Philox-10 evaluation (~40 SASS
// instructions, the key schedule held in uniform registers), one
// Box-Muller pair, the quadratic, the accept's logf and the selects,
// against 8 bytes of history: about half the instructions of one
// evaluation per draw. Evaluating step k + 1's draws beside step k's
// density and accept (a one-step software pipeline) measured 1-3% slower
// on the H100, and spilled at Rosenbrock D = 3, so each step draws its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"

namespace mm {

// the state types of the C entries (_build.STATE_TYPES)
enum StateType : int { kF32 = 0, kI32 = 1 };

template <class T, class P, class PosT, int D>
__global__ void __launch_bounds__(kThreads)
    mh_multistep_kernel(const PosT* __restrict__ pos,
                        const float* __restrict__ logp,
                        const float* __restrict__ tparams,
                        const float* __restrict__ pparams, int k_steps,
                        int n_chains, uint32_t chain0, uint32_t k0,
                        uint32_t k1, uint32_t step0,
                        PosT* __restrict__ pos_out,
                        float* __restrict__ logp_out,
                        PosT* __restrict__ hist, long long hist_sk,
                        long long hist_sc) {
  // the accept uniform follows the proposal's words
  constexpr int kPropWords = P::template words<D>();
  constexpr int kWords = kPropWords + 1;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const T t(tparams);  // before the exit: a target may fill a block table
  const P q(pparams);
  if (c >= n_chains) return;
  const uint32_t chain = chain0 + (uint32_t)c;
  // Past D = 3 (the user instances) the accept's logf is taken before the
  // proposal and the history row recomputed each step: fewer values live
  // across the calls to sincosf's slow path (never taken here, but
  // emitted), which otherwise spill at D = 5 (ptxas -v). The built-in
  // instances (D <= 3) keep their code.
  constexpr bool kLean = D > 3;
  PosT x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = pos[c * D + d];
  float lp = logp[c];
  PosT* row = !kLean && hist != nullptr ? hist + (long long)c * hist_sc
                                        : nullptr;

  for (int k = 0; k < k_steps; ++k) {
    uint32_t w[4 * stream_evals<kWords>()];
    step_words<kWords>(chain, step0 + (uint32_t)k, k0, k1, w);
    float log_u = 0.0f;
    if constexpr (kLean) log_u = logf(unit_open(w[kPropWords]));
    PosT y[D];
    q.template propose<D>(x, w, y);
    const float lpp = t.template logp<D>(y);
    if constexpr (!kLean) log_u = logf(unit_open(w[kPropWords]));
    const bool accept = (lpp - lp) > log_u;
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = accept ? y[d] : x[d];
    lp = accept ? lpp : lp;
    if constexpr (kLean) {
      if (hist != nullptr) {
        PosT* r = hist + (long long)k * hist_sk + (long long)c * hist_sc;
#pragma unroll
        for (int d = 0; d < D; ++d) r[d] = x[d];
      }
    } else if (row != nullptr) {
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[d];
      row += hist_sk;
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) pos_out[c * D + d] = x[d];
  logp_out[c] = lp;
}

struct MhArgs {
  const void* pos;
  const void* logp;
  const void* tparams;
  const void* pparams;
  int k_steps, n_chains;
  uint32_t chain0, k0, k1, step0;
  void* pos_out;
  void* logp_out;
  void* hist;
  long long hist_sk, hist_sc;
  void* stream;
};

template <class T, class P, class PosT, int D>
int launch_mh(const MhArgs& a) {
  mh_multistep_kernel<T, P, PosT, D>
      <<<blocks_for(a.n_chains), kThreads, 0, (cudaStream_t)a.stream>>>(
          (const PosT*)a.pos, (const float*)a.logp,
          (const float*)a.tparams, (const float*)a.pparams, a.k_steps,
          a.n_chains, a.chain0, a.k0, a.k1, a.step0, (PosT*)a.pos_out,
          (float*)a.logp_out, (PosT*)a.hist, a.hist_sk, a.hist_sc);
  return (int)cudaGetLastError();
}

}  // namespace mm
