// The NUTS tree math, one thread per chain, shared by Kernel 3
// (nuts_subtree.cu, one subtree per launch) and Kernel 4 (nuts_full.cu, a
// whole NUTS step per launch): the leaf, the merge rule and Kernel 3's
// merge hash. Each kernel keeps its own U-turn stack in shared memory (a
// row of Kernel 4 drops the proposal's gradient and logp: nothing reads
// them there).
//
// Port of mini_mcmc_tpu/ops/pallas/nuts_subtree.py:build_subtree_inkernel
// (the Pallas analog of ops/nuts.py:_build_subtree_batched, reference
// nuts.rs:763-946). The 2^j leaves are visited chronologically; after
// leaf i the recursion's bottom-up merges are the ctz(i + 1) merges of a
// binary counter, so the stack holds at most j + 1 rows and the leaf row
// is pushed at height popcount(i). Per leaf: one leapfrog, the slice count
// n' = [logu < joint], the divergence check (logu - 1000 < joint), the
// acceptance statistic min(1, exp(joint - joint0)) with a NaN energy
// difference laundered to 0 acceptance, and the merge cascade with the
// progressive swap (the right subtree wins with probability
// n_b / max(n_a + n_b, 1)) and the U-turn check between the merged
// subtree's first state and the current state, signed by the direction.
#pragma once

#include <stdint.h>

#include "philox.cuh"
#include "targets.cuh"

namespace mm {

// Compile-time bound on max_depth (Stan's default); the wrappers raise
// above it (ops/kernels/nuts_subtree.py:MAX_DEPTH).
constexpr int kMaxDepth = 10;
constexpr float kDivergenceDelta = 1000.0f;

// The merge rule of nuts.rs:858-929: the right subtree's proposal wins with
// probability n_b / max(n_a + n_b, 1); the merged subtree continues iff
// neither its first state nor the current one has turned back against the
// direction v.
template <int D>
__device__ __forceinline__ bool merge_no_uturn(const float (&x)[D],
                                               const float (&m)[D],
                                               const float* first_pos,
                                               const float* first_mom,
                                               int stride, float v) {
  float dot_a = 0.0f, dot_cur = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float dc = x[d] - first_pos[d * stride];
    dot_a += dc * first_mom[d * stride];
    dot_cur += dc * m[d];
  }
  return (v * dot_a >= 0.0f) && (v * dot_cur >= 0.0f);
}

// nuts_subtree.py:_mix32, the murmur3 finalizer in int32 arithmetic:
// multiplies wrap (done on uint32_t, since signed overflow is undefined in
// C++) and right shifts are arithmetic (on int32_t), as in JAX.
__device__ __forceinline__ int32_t mix32(int32_t x) {
  x = x ^ (x >> 16);
  x = (int32_t)((uint32_t)x * 0x85EBCA6Bu);
  x = x ^ (x >> 13);
  x = (int32_t)((uint32_t)x * 0xC2B2AE35u);
  return x ^ (x >> 16);
}

// nuts_subtree.py:_hash_u24 and _hash_unit: 24 hashed bits of
// (seed0, seed1, event, lane) mapped to (0, 1), never 0.
__device__ __forceinline__ int32_t hash_u24(int32_t seed0, int32_t seed1,
                                            int32_t event, int32_t lane) {
  int32_t x = (int32_t)((uint32_t)seed0 + (uint32_t)event * 0x9E3779B9u);
  x = mix32(lane ^ x);
  x = mix32(x ^ seed1);
  return (x & 0x7FFFFFFF) >> 7;
}

__device__ __forceinline__ float hash_unit(int32_t seed0, int32_t seed1,
                                           int32_t event, int32_t lane) {
  return (float)hash_u24(seed0, seed1, event, lane) * (1.0f / 16777216.0f) +
         (1.0f / 33554432.0f);
}

// One leaf's checks after its leapfrog.
struct Leaf {
  float logp;
  bool n;      // in the slice: logu < joint
  bool s;      // not divergent: logu - 1000 < joint
  float alpha; // min(1, exp(joint - joint0)), 0 for a NaN energy
};

// One leaf: a leapfrog of (x, m, g) at signed step eps_signed (nuts.rs:
// 979-996) and its slice, divergence and acceptance checks (nuts.rs:
// 795-830). Kernel 3 (nuts_subtree.cu) and Kernel 4 (nuts_full.cu) both
// run it.
template <class T, int D>
__device__ __forceinline__ Leaf leaf(const T& t, float (&x)[D],
                                     float (&m)[D], float (&g)[D],
                                     float eps_signed, float logu,
                                     float joint0) {
  const float half = eps_signed * 0.5f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    m[d] = m[d] + g[d] * half;
    x[d] = x[d] + m[d] * eps_signed;
  }
  float lp;
  if constexpr (has_logp_and_grad<T, D>::value) {
    lp = t.template logp_and_grad<D>(x, g);  // one pass (targets.cuh)
#pragma unroll
    for (int d = 0; d < D; ++d) m[d] = m[d] + g[d] * half;
  } else {
    t.template grad<D>(x, g);
#pragma unroll
    for (int d = 0; d < D; ++d) m[d] = m[d] + g[d] * half;
    lp = t.template logp<D>(x);
  }

  float ke = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) ke += m[d] * m[d];
  const float joint = lp - 0.5f * ke;
  float delta = joint - joint0;
  if (delta != delta) delta = -1e30f;  // NaN energy: 0 acceptance
  return Leaf{lp, logu < joint, (logu - kDivergenceDelta) < joint,
              fminf(1.0f, expf(delta))};
}

}  // namespace mm
