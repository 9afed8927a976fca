// Kernel 2: K whole HMC steps per launch.
//
// The kernel template and its launch, shared by the built-in library
// (hmc_multistep.cu, which also holds the Philox check entry) and the
// per-density libraries of user targets (ops/kernels/user_density.py).
//
// Replaces mini_mcmc_tpu/ops/pallas/hmc_full.py:make_pallas_hmc_multistep
// (and make_pallas_hmc_step, its K = 1 case without history). For each of
// the K steps, per chain: N(0, 1) momentum from the (chain, step)'s Philox
// word stream (philox.cuh:step_words, paired Box-Muller; the chain its
// global index, chain0 + the launch's chain),
// h_cur, L leapfrog steps at eps[k], logp and h_prop, the accept
// `(h_cur - h_prop) >= logf(u)` with true selects (a NaN or -inf proposal
// compares false and is rejected without touching the kept state), and the
// kept position written to hist[k, c, :].
//
// `hist` points into the runner's preallocated sample cube; its k and
// chain strides are arguments, so the time-major [N, C, D] cube and the
// chain-major [C, N, D] cube are both written in place with no copy. A
// null `hist` skips the writes (the K = 1 step, and burn-in blocks).
//
// What bounds it on the H100: the state stays in registers across all K
// steps, and the only device-memory traffic inside the launch is the
// 12-byte history row per chain per step (D = 3). The work is about 45
// f32 flops per leapfrog per chain plus the step's draws, so the kernel is
// bound by FP32 issue and dependent-operation latency, not by bandwidth.
// The draws take the fewest Philox evaluations the step's 2 ceil(D / 2) + 1
// words need (one at D = 2, two at D = 3, 4), each cosine and sine of a
// Box-Muller angle a normal: at L = 1 (MALA) they are most of a step.
// 65,536 chains are 65,536 threads, about a quarter of what 132 SMs hold;
// occupancy is left to later tuning.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"

namespace mm {


template <class T, int D>
__global__ void __launch_bounds__(kThreads)
    multistep_kernel(const float* __restrict__ pos,
                     const float* __restrict__ logp,
                     const float* __restrict__ grad,
                     const float* __restrict__ eps,
                     const float* __restrict__ params, int k_steps,
                     int n_leapfrog, int n_chains, uint32_t chain0,
                     uint32_t seed_lo, uint32_t seed_hi, uint32_t step0,
                     float* __restrict__ pos_out,
                     float* __restrict__ logp_out,
                     float* __restrict__ grad_out, float* __restrict__ hist,
                     long long hist_sk, long long hist_sc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const T t(params);
  float x[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = pos[c * D + d];
    g[d] = grad[c * D + d];
  }
  float lp = logp[c];
  // the step's words: normals 2p, 2p + 1 from words 2p, 2p + 1, the accept
  // uniform from word 2 ceil(D / 2)
  constexpr int kPairs = (D + 1) / 2;
  constexpr int kWords = 2 * kPairs + 1;

  for (int k = 0; k < k_steps; ++k) {
    const uint32_t step = step0 + (uint32_t)k;
    uint32_t w[4 * stream_evals<kWords>()];
    step_words<kWords>(chain0 + (uint32_t)c, step, seed_lo, seed_hi, w);
    float m[D], xp[D], gp[D];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      float cs, sn;
      box_muller_pair(w[2 * p], w[2 * p + 1], cs, sn);
      m[2 * p] = cs;
      if (2 * p + 1 < D) m[2 * p + 1] = sn;
    }
    float ke0 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ke0 += m[d] * m[d];
      xp[d] = x[d];
      gp[d] = g[d];
    }
    const float h_cur = -lp + 0.5f * ke0;

    leapfrog<T, D>(t, xp, m, gp, eps[k], n_leapfrog);

    const float lpp = t.template logp<D>(xp);
    float ke1 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) ke1 += m[d] * m[d];
    const float h_prop = -lpp + 0.5f * ke1;
    const float u = unit_open(w[2 * kPairs]);
    const bool accept = (h_cur - h_prop) >= logf(u);

#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = accept ? xp[d] : x[d];
      g[d] = accept ? gp[d] : g[d];
    }
    lp = accept ? lpp : lp;
    if (hist != nullptr) {
      float* row = hist + (long long)k * hist_sk + (long long)c * hist_sc;
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[d];
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) {
    pos_out[c * D + d] = x[d];
    grad_out[c * D + d] = g[d];
  }
  logp_out[c] = lp;
}

struct MultistepArgs {
  const void *pos, *logp, *grad, *eps, *params;
  int k_steps, n_leapfrog, n_chains;
  uint32_t chain0, seed_lo, seed_hi, step0;
  void *pos_out, *logp_out, *grad_out, *hist;
  long long hist_sk, hist_sc;
  void* stream;
};

template <class T, int D>
int launch_multistep(const MultistepArgs& a) {
  multistep_kernel<T, D><<<blocks_for(a.n_chains), kThreads, 0,
                           (cudaStream_t)a.stream>>>(
      (const float*)a.pos, (const float*)a.logp, (const float*)a.grad,
      (const float*)a.eps, (const float*)a.params, a.k_steps, a.n_leapfrog,
      a.n_chains, a.chain0, a.seed_lo, a.seed_hi, a.step0,
      (float*)a.pos_out,
      (float*)a.logp_out, (float*)a.grad_out, (float*)a.hist, a.hist_sk,
      a.hist_sc);
  return (int)cudaGetLastError();
}

}  // namespace mm
