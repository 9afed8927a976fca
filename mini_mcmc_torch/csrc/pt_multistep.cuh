// Kernel 8: K fused parallel-tempering steps per launch.
//
// The kernel template and its launch, shared by the built-in library
// (pt_multistep.cu: D = 1 and 2) and the per-density libraries of user
// densities (ops/kernels/user_density.py, the value-only table: D = 1-16).
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
// (chain0 + c, step0 + k, t, i) under the run's 64-bit key (philox.cuh,
// Kernel 8; chain0 the launch's first global chain):
// words x, y the proposal normal(s), word z the accept uniform, word w at
// i = 0 the swap uniform of pair (t, t+1). Past D = 2, normals 2p and
// 2p + 1 are the cosine and sine of box_muller_pair on words x, y of
// draw p T + t (T the rungs), sub-draw i; D = 1 and 2 take draw t alone.
// The twin (ops/kernels/pt_full.py) reproduces them, and the cube depends neither
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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "philox.cuh"

namespace mm {

constexpr unsigned kPtLanes = 0xFFFFFFFFu;

template <class T, int D, int TMAX>
__global__ void __launch_bounds__(kThreads)
    pt_multistep_kernel(const float* __restrict__ pos,
                        const float* __restrict__ logp,
                        const float* __restrict__ sa_in,
                        const float* __restrict__ tparams,
                        const float* __restrict__ ladder, int n_chains,
                        int n_temps, int k_steps, int n_inner, int parity0,
                        uint32_t chain0, uint32_t k0, uint32_t k1,
                        uint32_t step0,
                        float* __restrict__ pos_out,
                        float* __restrict__ logp_out,
                        float* __restrict__ sa_out, float* __restrict__ hist,
                        long long hist_sk, long long hist_sc) {
  static_assert(D >= 1 && D <= 16, "the user instances run D = 1-16");
  static_assert(kThreads % TMAX == 0 && 32 % TMAX == 0,
                "a chain's rungs stay in one warp");
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = (int)(g / TMAX);
  const int r = (int)(g % TMAX);  // this thread's rung
  // idle lanes (t >= T, or past the last chain) still join every shuffle
  const bool live = c < n_chains && r < n_temps;
  const bool has_pair = live && r + 1 < n_temps;
  const T t(tparams);
  const uint32_t chain = chain0 + (uint32_t)c;  // the global chain

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
        const U32x4 w = philox4x32_10(
            U32x4{chain, step, (uint32_t)r, (uint32_t)i}, k0, k1);
        float n[D];
        if constexpr (D == 1) {
          n[0] = box_muller(w.x, w.y);
        } else {
          box_muller_pair(w.x, w.y, n[0], n[1]);
        }
        // past D = 2: normals 2p and 2p + 1 from words x, y of draw
        // p T + t (the last sine unused at odd D)
#pragma unroll
        for (int p = 1; 2 * p < D; ++p) {
          const U32x4 v = philox4x32_10(
              U32x4{chain, step, (uint32_t)(p * n_temps + r), (uint32_t)i},
              k0, k1);
          float cs, sn;
          box_muller_pair(v.x, v.y, cs, sn);
          n[2 * p] = cs;
          if (2 * p + 1 < D) n[2 * p + 1] = sn;
        }
        float y[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          y[d] = __fadd_rn(x[d], __fmul_rn(scale[d], n[d]));
        }
        const float lpp = t.template logp<D>(y);
        const bool accept =
            __fmul_rn(beta, __fsub_rn(lpp, lp)) > logf(unit_open(w.z));
#pragma unroll
        for (int d = 0; d < D; ++d) x[d] = accept ? y[d] : x[d];
        lp = accept ? lpp : lp;
        if (i == 0) u_swap = unit_open(w.w);
      }
    }

    // the swap sweep: pair (r, r+1) is active on the step's parity; its
    // lower lane decides, both lanes exchange
    const int par = (parity0 + k) & 1;
    const bool lower = has_pair && (r & 1) == par;
    const bool upper = live && r >= 1 && ((r - 1) & 1) == par;
    const int partner = lower ? r + 1 : (upper ? r - 1 : r);
    const float lp_other = __shfl_sync(kPtLanes, lp, partner, TMAX);
    const bool decided =
        lower &&
        __fmul_rn(dbeta, __fsub_rn(lp_other, lp)) > logf(u_swap);
    const bool from_lower =
        __shfl_sync(kPtLanes, (int)decided, partner, TMAX) != 0;
    const bool swap = lower ? decided : (upper && from_lower);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float other = __shfl_sync(kPtLanes, x[d], partner, TMAX);
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

struct PtArgs {
  const void* pos;
  const void* logp;
  const void* sa;
  const void* tparams;
  const void* ladder;
  int n_chains, n_temps, k_steps, n_inner, parity0;
  uint32_t chain0, k0, k1, step0;
  void* pos_out;
  void* logp_out;
  void* sa_out;
  void* hist;
  long long hist_sk, hist_sc;
  void* stream;
};

template <class T, int D, int TMAX>
int launch_pt_ladder(const PtArgs& a) {
  pt_multistep_kernel<T, D, TMAX>
      <<<(int)(((long long)a.n_chains * TMAX + kThreads - 1) / kThreads),
         kThreads, 0, (cudaStream_t)a.stream>>>(
          (const float*)a.pos, (const float*)a.logp, (const float*)a.sa,
          (const float*)a.tparams, (const float*)a.ladder, a.n_chains,
          a.n_temps, a.k_steps, a.n_inner, a.parity0, a.chain0, a.k0, a.k1,
          a.step0,
          (float*)a.pos_out, (float*)a.logp_out, (float*)a.sa_out,
          (float*)a.hist, a.hist_sk, a.hist_sc);
  return (int)cudaGetLastError();
}

// TMAX: the fewest lanes (4, 8 or 16) that hold a ladder of 2-16 rungs
template <class T, int D>
int launch_pt(const PtArgs& a) {
  if (a.n_temps < 2 || a.n_temps > 16) return (int)cudaErrorInvalidValue;
  if (a.n_temps <= 4) return launch_pt_ladder<T, D, 4>(a);
  if (a.n_temps <= 8) return launch_pt_ladder<T, D, 8>(a);
  return launch_pt_ladder<T, D, 16>(a);
}

}  // namespace mm
