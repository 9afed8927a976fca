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
// cold rung goes to hist[k, c, :] through the runner's strides.
//
// Layout: the JAX package's [T, D, C] positions, [T, C] logp and [T-1, C]
// EWMA, chains last, so a warp's loads are consecutive. One thread per
// chain keeps its T x D positions, T logps and T - 1 EWMAs in registers for
// all K steps: the rung loops are unrolled to TMAX (4, 8 or 16, the
// smallest that holds T) and guarded by the runtime T, so every index is a
// constant after unrolling. The ladder (beta [T], beta_t - beta_{t+1}
// [T-1], sigma_d / sqrt(beta_t) [T, D]) is one small device array, read
// with uniform __ldg loads.
//
// Draws: Philox at (c, step0 + k, draw, sub) under the run's 64-bit key
// (philox.cuh, Kernel 8), so the twin (ops/kernels/pt_full.py) reproduces
// them and the cube depends neither on K nor on the grid. The proposal and
// the products of the accepts are rounded alone (__fmul_rn, __fadd_rn), as
// PyTorch rounds them.
//
// What bounds it on the H100: operations, not bytes. At T = 8, D = 1 a step
// is 23 Philox-10 evaluations (~83 lane instructions each), 8 Box-Muller
// transforms, 8 mixture densities and ~12 logf against 4 bytes of history
// per chain; the state never leaves registers between the K steps. At
// 8,192 chains only 256 warps run, fewer than the card's 528 schedulers,
// so the latency of each chain's dependent chain of instructions, not the
// issue rate, sets the time (PERF.md, Kernel 8).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace {

constexpr uint32_t kSwapDraw = 0x10000u;

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
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const T t(tparams);
  const float* beta = ladder;
  const float* dbeta = ladder + n_temps;
  const float* scale = ladder + 2 * n_temps - 1;  // [T, D]
  const uint32_t chain = (uint32_t)c;

  float x[TMAX][D], lp[TMAX], sa[TMAX - 1];
#pragma unroll
  for (int r = 0; r < TMAX; ++r) {
    if (r >= n_temps) continue;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[r][d] = pos[((long long)r * D + d) * n_chains + c];
    }
    lp[r] = logp[(long long)r * n_chains + c];
    if (r + 1 < TMAX && r + 1 < n_temps) {
      sa[r] = sa_in[(long long)r * n_chains + c];
    }
  }

  for (int k = 0; k < k_steps; ++k) {
    const uint32_t step = step0 + (uint32_t)k;
    for (int i = 0; i < n_inner; ++i) {
#pragma unroll
      for (int r = 0; r < TMAX; ++r) {
        if (r >= n_temps) continue;
        const uint32_t draw0 = (uint32_t)(r * (D + 1));
        float y[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float n = mm::normal_at(chain, step, draw0 + d, k0, k1, i);
          y[d] = __fadd_rn(x[r][d], __fmul_rn(__ldg(scale + r * D + d), n));
        }
        const float lpp = t.template logp<D>(y);
        const float u = mm::uniform_at(chain, step, draw0 + D, k0, k1, i);
        const bool accept =
            __fmul_rn(__ldg(beta + r), __fsub_rn(lpp, lp[r])) > logf(u);
#pragma unroll
        for (int d = 0; d < D; ++d) x[r][d] = accept ? y[d] : x[r][d];
        lp[r] = accept ? lpp : lp[r];
      }
    }

    // disjoint pairs: deciding and exchanging one pair at a time equals
    // the JAX package's shift-and-select over all pairs at once
    const int par = (parity0 + k) & 1;
#pragma unroll
    for (int r = 0; r + 1 < TMAX; ++r) {
      if (r + 1 >= n_temps || (r & 1) != par) continue;
      const float u = mm::uniform_at(chain, step, kSwapDraw + r, k0, k1);
      const bool swap =
          __fmul_rn(__ldg(dbeta + r), __fsub_rn(lp[r + 1], lp[r])) > logf(u);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float lo = x[r][d], hi = x[r + 1][d];
        x[r][d] = swap ? hi : lo;
        x[r + 1][d] = swap ? lo : hi;
      }
      const float lo = lp[r], hi = lp[r + 1];
      lp[r] = swap ? hi : lo;
      lp[r + 1] = swap ? lo : hi;
      sa[r] = __fadd_rn(__fmul_rn(0.95f, sa[r]),
                        __fmul_rn(0.05f, swap ? 1.0f : 0.0f));
    }

    if (hist != nullptr) {
      float* row = hist + (long long)k * hist_sk + (long long)c * hist_sc;
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = x[0][d];
    }
  }

#pragma unroll
  for (int r = 0; r < TMAX; ++r) {
    if (r >= n_temps) continue;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      pos_out[((long long)r * D + d) * n_chains + c] = x[r][d];
    }
    logp_out[(long long)r * n_chains + c] = lp[r];
    if (r + 1 < TMAX && r + 1 < n_temps) {
      sa_out[(long long)r * n_chains + c] = sa[r];
    }
  }
}

}  // namespace

// The instantiated (target, D) are those of PT_INSTANCES in
// ops/kernels/_build.py, for ladders of 2 to 16 rungs (PT_MAX_TEMPS); any
// other returns cudaErrorInvalidValue.
extern "C" int mm_pt_multistep(const void* pos, const void* logp,
                               const void* sa, const void* tparams,
                               const void* ladder, int n_chains, int dim,
                               int n_temps, int k_steps, int n_inner,
                               int target, int parity0, uint32_t seed_lo,
                               uint32_t seed_hi, uint32_t step0,
                               void* pos_out, void* logp_out, void* sa_out,
                               void* hist, long long hist_sk,
                               long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (n_temps < 2 || n_temps > 16) return (int)cudaErrorInvalidValue;
#define MM_PT(T, D, TMAX)                                                   \
  pt_multistep_kernel<T, D, TMAX>                                           \
      <<<mm::blocks_for(n_chains), mm::kThreads, 0, (cudaStream_t)stream>>>( \
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
  if (target == mm::kGaussian2D && dim == 2) {
    MM_PT_LADDER(mm::Gaussian2D, 2);
  } else if (target == mm::kGaussianMixture1D && dim == 1) {
    MM_PT_LADDER(mm::GaussianMixture1D, 1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef MM_PT_LADDER
#undef MM_PT
  return (int)cudaGetLastError();
}
