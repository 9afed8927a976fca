// Kernel 3: one 2^j-leaf NUTS subtree per launch.
//
// The kernel template and its launch, shared by the built-in library
// (nuts_subtree.cu, every instance of MM_DISPATCH) and the per-density
// libraries of user targets (ops/kernels/user_density.py).
//
// Replaces mini_mcmc_tpu/ops/pallas/nuts_subtree.py:make_pallas_subtree
// with its contract: (pos, mom, grad [C, D], logu, v, eps, joint0,
// active [C], j, seed words) -> (end_pos, end_mom, end_grad, prop_pos,
// prop_grad [C, D], prop_logp [C], n, s, alpha, n_alpha, diverged [C]).
// The leaf and the merge rule are nuts_tree.cuh's, shared with Kernel 4.
//
// Merge uniforms come from the TPU kernel's own murmur3 counter hash over
// (seed0, seed1, i * (max_depth + 1) + k, lane), with the chain's global
// index (chain0 + the launch's chain) as the lane: the plain twin
// (ops/kernels/nuts_subtree.py) and the JAX kernel in interpret mode draw
// the same numbers, so this tier is the one NUTS path held to the JAX
// package chain for chain.
//
// One thread per chain, on one wave of blocks. The 2^j leaves are visited
// chronologically; after leaf i the recursion's bottom-up merges are the
// ctz(i + 1) merges of a binary counter, so the U-turn stack holds j + 1
// rows and leaf i is pushed at height popcount(i). A thread stops once its
// own s is false (the TPU kernel runs all 2^j leaves for every lane); what
// the caller reads is unchanged by that: n, s, alpha, n_alpha and the
// divergence flag always, the end state and the proposal only while s
// holds. Every thread of a warp starts at leaf 0, so the active lanes share
// the leaf i and its merge cascade runs converged.
//
// What bounds it on the H100: at D = 2 the launch moves 99 bytes a chain
// (0.0039 ms at 131,072 chains), while the deepest chain's leaves run one
// after another, each a dependent chain of gradient, momentum, position,
// logp and merges: latency, not bytes or issue, sets the launch once the
// short chains have stopped. So the design shortens that chain. The U-turn
// stack lives in shared memory, sized to the launch's j + 1 rows (a block
// of subtree_threads<D>() threads: 128 while a depth-10 stack of 128 fits
// in a block's 227 KB, as at every D <= 9, else 64, or one warp): rows
// addressed by the runtime height cannot live in registers, and a
// per-thread array of them goes to local memory (448 bytes a thread at
// D = 2, ~1,000 threads a SM, against L1's share of 256 KB). On an NVIDIA
// H100 80GB HBM3 at 700 W, at 131,072 chains of the bench's NUTS
// equilibrium (j = 0..5): 5.5-6.1, 6.1-6.3, 7.0-7.4, 9.8-9.9, 12.7-12.9,
// 13.3-13.5 us, against 7.1-7.2, 9.6, 15.8-16.1, 25.9-26.1, 28.0-28.3,
// 27.3-28.2 us with the local-memory stack (PERF.md); the deepest chain's
// 16 leaves at j = 4 take ~0.46 us each. Measured slower and not kept:
// hashing a leaf's merge uniforms ahead of its leapfrog (all of them:
// 4-39% slower; the first alone: 2-15%), and a persistent grid whose warps
// take 32 chains from a device counter (0.8-4.9 us more a launch, built
// on the all-ahead form).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "nuts_tree.cuh"

namespace mm {

// A thread's U-turn stack in shared memory, structure-of-arrays rows
// indexed by thread, [row][field][thread], so a warp's accesses fall on 32
// banks: j + 1 rows of first_pos[D], first_mom[D], prop_pos[D],
// prop_grad[D], prop_logp and n.
template <int D>
constexpr int kSubtreeRow = 4 * D + 2;

template <int D>
__host__ __device__ constexpr size_t subtree_stack_bytes(int rows,
                                                         int threads) {
  return (size_t)rows * kSubtreeRow<D> * threads * sizeof(float);
}

// The threads of a block: the most of 128, 64 and 32 whose stack at
// kMaxDepth + 1 rows fits in a block's shared memory (128 at D <= 9, where
// the built-in instances are; at D = 16 64).
template <int D>
__host__ __device__ constexpr int subtree_threads() {
  return subtree_stack_bytes<D>(kMaxDepth + 1, kThreads) <= kMaxBlockSmem
             ? kThreads
         : subtree_stack_bytes<D>(kMaxDepth + 1, kThreads / 2) <=
                 kMaxBlockSmem
             ? kThreads / 2
             : 32;
}

// The blocks that a j = 4 stack (five rows) leaves room for on an SM (8 at
// D = 2, so the bench's 1,024 blocks run in one wave); the register cap
// they set costs no occupancy.
template <int D>
__host__ __device__ constexpr int subtree_min_blocks() {
  return (int)((228 * 1024) /
               (subtree_stack_bytes<D>(5, subtree_threads<D>()) + 1024));
}

template <class T, int D>
__global__ void __launch_bounds__(subtree_threads<D>(),
                                  subtree_min_blocks<D>())
    subtree_kernel(const float* __restrict__ pos,
                   const float* __restrict__ mom,
                   const float* __restrict__ grad,
                   const float* __restrict__ logu_in,
                   const int32_t* __restrict__ v_in,
                   const float* __restrict__ eps_in,
                   const float* __restrict__ joint0_in,
                   const uint8_t* __restrict__ active_in,
                   const float* __restrict__ params, int j, int max_depth,
                   int32_t seed0, int32_t seed1, uint32_t chain0,
                   int n_chains, float* __restrict__ end_pos,
                   float* __restrict__ end_mom,
                   float* __restrict__ end_grad,
                   float* __restrict__ prop_pos,
                   float* __restrict__ prop_grad,
                   float* __restrict__ prop_logp, int32_t* __restrict__ n_out,
                   uint8_t* __restrict__ s_out,
                   float* __restrict__ alpha_out,
                   int32_t* __restrict__ n_alpha_out,
                   uint8_t* __restrict__ diverged_out) {
  extern __shared__ float smem[];
  // row r of this thread's stack: field f at row(r)[f * S]
  float* const stack = smem + threadIdx.x;
  constexpr int S = subtree_threads<D>();
  const auto row = [stack](int r) {
    return stack + r * kSubtreeRow<D> * S;
  };
  constexpr int kFirstPos = 0, kFirstMom = D, kPropPos = 2 * D,
                kPropGrad = 3 * D, kLogp = 4 * D, kN = 4 * D + 1;

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  // the hash's lane: the chain's global index
  const int32_t lane = (int32_t)(chain0 + (uint32_t)c);
  const T t(params);
  float x[D], m[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = pos[c * D + d];
    m[d] = mom[c * D + d];
    g[d] = grad[c * D + d];
  }
  const float v = (float)v_in[c];
  const float eps_signed = eps_in[c] * v;
  const float logu = logu_in[c], joint0 = joint0_in[c];
  const bool active = active_in[c] != 0;
  const int events = max_depth + 1;

  bool s = true, diverged = false;
  int n = 0, n_alpha = 0;
  float alpha = 0.0f;
  for (int i = 0; i < (1 << j) && s; ++i) {
    const Leaf lf = leaf<T, D>(t, x, m, g, eps_signed, logu, joint0);
    if (active) {  // live = active & s, and s holds inside the loop
      n += lf.n ? 1 : 0;
      alpha += lf.alpha;
      n_alpha += 1;
      diverged |= !lf.s;
    }
    s = lf.s;

    // push the leaf row at the binary counter's height
    const int sp = __popc(i);
    float* const top = row(sp);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      top[(kFirstPos + d) * S] = x[d];
      top[(kFirstMom + d) * S] = m[d];
      top[(kPropPos + d) * S] = x[d];
      top[(kPropGrad + d) * S] = g[d];
    }
    top[kLogp * S] = lf.logp;
    top[kN * S] = lf.n ? 1.0f : 0.0f;

    // merge cascade: ctz(i + 1) merges; the top (right) entry is the row
    // just written, then each merged row in turn
    const int n_merges = __ffs(i + 1) - 1;
    for (int k = 0; k < n_merges; ++k) {
      const float uk = hash_unit(seed0, seed1, i * events + k, lane);
      float* const a = row(sp - 1 - k);
      const float* const b = row(sp - k);
      const float n_a = a[kN * S], n_b = b[kN * S];
      const bool take_b = uk < n_b / fmaxf(n_a + n_b, 1.0f);
      const bool ok = merge_no_uturn<D>(x, m, a + kFirstPos * S,
                                            a + kFirstMom * S, S, v);
      if (take_b) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          a[(kPropPos + d) * S] = b[(kPropPos + d) * S];
          a[(kPropGrad + d) * S] = b[(kPropGrad + d) * S];
        }
        a[kLogp * S] = b[kLogp * S];
      }
      a[kN * S] = n_a + n_b;
      s = s && ok;
    }
  }

  const float* const root = row(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    end_pos[c * D + d] = x[d];
    end_mom[c * D + d] = m[d];
    end_grad[c * D + d] = g[d];
    prop_pos[c * D + d] = root[(kPropPos + d) * S];
    prop_grad[c * D + d] = root[(kPropGrad + d) * S];
  }
  prop_logp[c] = root[kLogp * S];
  n_out[c] = n;
  s_out[c] = s ? 1 : 0;
  alpha_out[c] = alpha;
  n_alpha_out[c] = n_alpha;
  diverged_out[c] = diverged ? 1 : 0;
}

struct SubtreeArgs {
  const void *pos, *mom, *grad, *logu, *v, *eps, *joint0, *active, *params;
  int j, max_depth;
  int32_t seed0, seed1;
  uint32_t chain0;
  int n_chains;
  void *end_pos, *end_mom, *end_grad, *prop_pos, *prop_grad, *prop_logp,
      *n, *s, *alpha, *n_alpha, *diverged;
  int device;
  int* grid;  // when given: blocks per SM, SMs, and the launch's blocks
  void* stream;
};

template <class T, int D>
int launch_subtree(const SubtreeArgs& a) {
  static_assert(subtree_stack_bytes<D>(kMaxDepth + 1, subtree_threads<D>()) <=
                    kMaxBlockSmem,
                "the depth-10 stack does not fit a block of one warp");
  constexpr int kT = subtree_threads<D>();
  auto kernel = subtree_kernel<T, D>;
  const size_t smem = subtree_stack_bytes<D>(a.j + 1, kT);
  // the deepest stack's limit, on every launch: it belongs to the current
  // device's context
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)subtree_stack_bytes<D>(kMaxDepth + 1, kT));
  if (set != cudaSuccess) return (int)set;
  const int blocks = (a.n_chains + kT - 1) / kT;
  if (a.grid != nullptr) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kT, smem);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 a.device);
    }
    if (e != cudaSuccess) return (int)e;
    a.grid[0] = per_sm;
    a.grid[1] = sms;
    a.grid[2] = blocks;
  }
  kernel<<<blocks, kT, smem, (cudaStream_t)a.stream>>>(
      (const float*)a.pos, (const float*)a.mom, (const float*)a.grad,
      (const float*)a.logu, (const int32_t*)a.v, (const float*)a.eps,
      (const float*)a.joint0, (const uint8_t*)a.active,
      (const float*)a.params, a.j, a.max_depth, a.seed0, a.seed1,
      a.chain0, a.n_chains, (float*)a.end_pos, (float*)a.end_mom,
      (float*)a.end_grad,
      (float*)a.prop_pos, (float*)a.prop_grad, (float*)a.prop_logp,
      (int32_t*)a.n, (uint8_t*)a.s, (float*)a.alpha, (int32_t*)a.n_alpha,
      (uint8_t*)a.diverged);
  return (int)cudaGetLastError();
}

}  // namespace mm
