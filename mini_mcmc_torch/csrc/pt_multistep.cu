// Kernel 8: K fused parallel-tempering steps per launch.
//
// Replaces mini_mcmc_tpu/ops/pallas/tempering_full.py:
// make_pallas_pt_multistep (and its K = 1 form without history). For each
// of the K steps, per chain: n_inner random-walk Metropolis sweeps over the
// T rungs, rung t proposing x + sigma_d / sqrt(beta_t) * n and accepting
// iff beta_t (lp' - lp) > log(u); then the alternating-parity swap sweep
// (pairs t with t % 2 equal to the step's parity, (parity0 + k) % 2),
// accepting iff (beta_t - beta_{t+1}) (lp_{t+1} - lp_t) > log(u), and the
// swap EWMA sa = 0.95 sa + 0.05 swap on the active pairs
// (ops/tempering.py:287-320 in the JAX package, whose XLA form the twin
// follows operation for operation). Every accept and swap is a true
// select, so a -inf log density stays -inf and never becomes NaN. Only the
// cold rung goes to hist[k, c, :] through the runner's strides. Under a
// transform the replicas walk the unconstrained y and T is
// targets.cuh:Transformed<T, D>, each rung's density beta_t times
// T::logp(g(y)) + log|g'(y)| (ops/tempering.py:rung_logp on the wrapped
// target, mini_mcmc_tpu/samplers.py:805-816).
//
// Layout: the JAX package's [T, D, C] positions, [T, C] logp and [T-1, C]
// EWMA. One thread per (chain, rung): lane = chain_in_warp * TMAX + t, so
// a chain's rungs sit in adjacent lanes of one warp, 32 / TMAX chains to a
// warp (TMAX = 4, 8 or 16, the smallest that holds T; lanes with t >= T
// idle). Each thread keeps its rung's position, logp, beta_t, scales and
// the EWMA of pair (t, t+1) in registers for all K steps. The swap of an
// active pair is decided by its lower lane from the upper lane's logp
// (__shfl_sync), both lanes exchange position and logp by shuffle with
// the decision broadcast, and the lower lane updates the EWMA. The pairs
// are disjoint, so this equals the JAX package's shift-and-select.
//
// Draws: one Philox evaluation per (chain, rung, step, sweep), counter
// (c, step0 + k, t, i) under the run's 64-bit key (philox.cuh, Kernel 8):
// words x, y the proposal normal(s), word z the accept uniform, word w at
// i = 0 the swap uniform of pair (t, t+1). The twin
// (ops/kernels/pt_full.py) reproduces them, and the cube depends neither
// on K nor on the grid. The proposal and the products of the accepts are
// rounded alone (__fmul_rn, __fadd_rn), as PyTorch rounds them.
//
// What bounds it on the H100: operations, not bytes. At T = 8, D = 1 a
// chain-step is 8 Philox-10 evaluations (~83 lane instructions each), 8
// Box-Muller transforms, 8 mixture densities and ~12 logf against 4 bytes
// of history per chain; the state never leaves registers between the K
// steps. A thread per (chain, rung) gives 8,192 chains at T = 8 65,536
// threads, 512 blocks of 128 on the 132 SMs (one thread per chain filled
// only 64 of them), so the issue rate, not one thread's dependent
// latency, sets the time: 17.8 us per K = 16 block there, from 96.4 us
// with one thread per chain (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

template <class T, int D, int TMAX>
__global__ void __launch_bounds__(mm::kThreads)
    pt_multistep_kernel(const float* __restrict__ pos,
                        const float* __restrict__ logp,
                        const float* __restrict__ sa_in,
                        const float* __restrict__ tparams,
                        const float* __restrict__ ladder, int n_chains,
                        int n_temps, int k_steps, int n_inner, int parity0,
                        uint32_t k0, uint32_t k1, uint32_t step0,
                        float* __restrict__ pos_out,
                        float* __restrict__ logp_out,
                        float* __restrict__ sa_out, float* __restrict__ hist,
                        long long hist_sk, long long hist_sc) {
  static_assert(D == 1 || D == 2, "one Philox evaluation holds two normals");
  static_assert(mm::kThreads % TMAX == 0 && 32 % TMAX == 0,
                "a chain's rungs stay in one warp");
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = (int)(g / TMAX);
  const int r = (int)(g % TMAX);  // this thread's rung
  // idle lanes (t >= T, or past the last chain) still join every shuffle
  const bool live = c < n_chains && r < n_temps;
  const bool has_pair = live && r + 1 < n_temps;
  const T t(tparams);
  const uint32_t chain = (uint32_t)c;

  float x[D], lp = 0.0f, sa = 0.0f, beta = 0.0f, dbeta = 0.0f, scale[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = scale[d] = 0.0f;
  if (live) {
    beta = __ldg(ladder + r);
    const float* sc = ladder + 2 * n_temps - 1 + r * D;  // [T, D]
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = pos[((long long)r * D + d) * n_chains + c];
      scale[d] = __ldg(sc + d);
    }
    lp = logp[(long long)r * n_chains + c];
  }
  if (has_pair) {
    dbeta = __ldg(ladder + n_temps + r);
    sa = sa_in[(long long)r * n_chains + c];
  }

  for (int k = 0; k < k_steps; ++k) {
    const uint32_t step = step0 + (uint32_t)k;
    float u_swap = 1.0f;
    if (live) {
      for (int i = 0; i < n_inner; ++i) {
        const mm::U32x4 w = mm::philox4x32_10(
            mm::U32x4{chain, step, (uint32_t)r, (uint32_t)i}, k0, k1);
        float n[D];
        if constexpr (D == 1) {
          n[0] = mm::box_muller(w.x, w.y);
        } else {
          mm::box_muller_pair(w.x, w.y, n[0], n[1]);
        }
        float y[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          y[d] = __fadd_rn(x[d], __fmul_rn(scale[d], n[d]));
        }
        const float lpp = t.template logp<D>(y);
        const bool accept =
            __fmul_rn(beta, __fsub_rn(lpp, lp)) > logf(mm::unit_open(w.z));
#pragma unroll
        for (int d = 0; d < D; ++d) x[d] = accept ? y[d] : x[d];
        lp = accept ? lpp : lp;
        if (i == 0) u_swap = mm::unit_open(w.w);
      }
    }

    // the swap sweep: pair (r, r+1) is active on the step's parity; its
    // lower lane decides, both lanes exchange
    const int par = (parity0 + k) & 1;
    const bool lower = has_pair && (r & 1) == par;
    const bool upper = live && r >= 1 && ((r - 1) & 1) == par;
    const int partner = lower ? r + 1 : (upper ? r - 1 : r);
    const float lp_other = __shfl_sync(kFull, lp, partner, TMAX);
    const bool decided =
        lower &&
        __fmul_rn(dbeta, __fsub_rn(lp_other, lp)) > logf(u_swap);
    const bool from_lower =
        __shfl_sync(kFull, (int)decided, partner, TMAX) != 0;
    const bool swap = lower ? decided : (upper && from_lower);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float other = __shfl_sync(kFull, x[d], partner, TMAX);
      x[d] = swap ? other : x[d];
    }
    lp = swap ? lp_other : lp;
    if (lower) {
      sa = __fadd_rn(__fmul_rn(0.95f, sa),
                     __fmul_rn(0.05f, swap ? 1.0f : 0.0f));
    }

    if (hist != nullptr && live && r == 0) {
      float* row = hist + (long long)k * hist_sk + (long long)c * hist_sc;
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[d];
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      pos_out[((long long)r * D + d) * n_chains + c] = x[d];
    }
    logp_out[(long long)r * n_chains + c] = lp;
  }
  if (has_pair) sa_out[(long long)r * n_chains + c] = sa;
}

}  // namespace

// The instantiated (target, D, transformed) are those of PT_INSTANCES in
// ops/kernels/_build.py, for ladders of 2 to 16 rungs (PT_MAX_TEMPS); any
// other returns cudaErrorInvalidValue. `transformed` selects
// Transformed<T, D>, whose params are the bijector table ahead of T's own.
extern "C" int mm_pt_multistep(const void* pos, const void* logp,
                               const void* sa, const void* tparams,
                               const void* ladder, int n_chains, int dim,
                               int n_temps, int k_steps, int n_inner,
                               int target, int transformed, int parity0,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t step0,
                               void* pos_out, void* logp_out, void* sa_out,
                               void* hist, long long hist_sk,
                               long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (n_temps < 2 || n_temps > 16) return (int)cudaErrorInvalidValue;
#define MM_PT(T, D, TMAX)                                                   \
  pt_multistep_kernel<T, D, TMAX>                                           \
      <<<(int)(((long long)n_chains * TMAX + mm::kThreads - 1) /            \
               mm::kThreads),                                               \
         mm::kThreads, 0, (cudaStream_t)stream>>>(                          \
          (const float*)pos, (const float*)logp, (const float*)sa,          \
          (const float*)tparams, (const float*)ladder, n_chains, n_temps,   \
          k_steps, n_inner, parity0, seed_lo, seed_hi, step0,               \
          (float*)pos_out, (float*)logp_out, (float*)sa_out, (float*)hist,  \
          hist_sk, hist_sc)
#define MM_PT_LADDER(T, D)            \
  do {                                \
    if (n_temps <= 4) {               \
      MM_PT(T, D, 4);                 \
    } else if (n_temps <= 8) {        \
      MM_PT(T, D, 8);                 \
    } else {                          \
      MM_PT(T, D, 16);                \
    }                                 \
  } while (0)
#define MM_PT_TARGET(T, D)                      \
  do {                                          \
    if (transformed) {                          \
      using Transformed_ = mm::Transformed<T, D>; \
      MM_PT_LADDER(Transformed_, D);            \
    } else {                                    \
      MM_PT_LADDER(T, D);                       \
    }                                           \
  } while (0)
  if (target == mm::kGaussian2D && dim == 2) {
    MM_PT_TARGET(mm::Gaussian2D, 2);
  } else if (target == mm::kGaussianMixture1D && dim == 1) {
    MM_PT_TARGET(mm::GaussianMixture1D, 1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef MM_PT_TARGET
#undef MM_PT_LADDER
#undef MM_PT
  return (int)cudaGetLastError();
}
