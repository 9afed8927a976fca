// The NUTS subtree builder, one thread per chain. Kernel 3 (nuts_subtree.cu,
// one subtree per launch) runs build_subtree; Kernel 4 (nuts_full.cu, a
// whole NUTS step per launch) runs the same leaf() and merge rule inside
// its doubling loop, with a stack row that drops the proposal's gradient
// and logp (nothing reads them there).
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
//
// Early exit: the TPU kernel runs all 2^j leaves for every lane of a
// block; here a thread stops once its own s is false. What the caller
// reads is unchanged by that: n, s, alpha, n_alpha and the divergence flag
// always, the end state and the proposal only while s holds.
//
// The stack is a per-thread array, (max_depth + 1) rows of 4D + 2 floats
// (440 bytes at D = 2), in local memory (L1-cached): rows are addressed by
// the runtime height, so they cannot live in registers.
#pragma once

#include <stdint.h>

#include "philox.cuh"

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

// The subtree's outputs besides the end state (which the builder leaves in
// the x, m, g it was given) and the proposal (the root row, stack[0]).
struct SubtreeStats {
  bool s;
  int n;
  float alpha;
  int n_alpha;
  bool diverged;
};

template <int D>
struct StackRow {
  float first_pos[D], first_mom[D], prop_pos[D], prop_grad[D];
  float prop_logp;
  float n;
};

// One leaf's checks after its leapfrog.
struct Leaf {
  float logp;
  bool n;      // in the slice: logu < joint
  bool s;      // not divergent: logu - 1000 < joint
  float alpha; // min(1, exp(joint - joint0)), 0 for a NaN energy
};

// One leaf: a leapfrog of (x, m, g) at signed step eps_signed (nuts.rs:
// 979-996) and its slice, divergence and acceptance checks (nuts.rs:
// 795-830). Kernel 3 (build_subtree) and Kernel 4 (nuts_full.cu) both run
// it.
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
  t.template grad<D>(x, g);
#pragma unroll
  for (int d = 0; d < D; ++d) m[d] = m[d] + g[d] * half;
  const float lp = t.template logp<D>(x);

  float ke = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) ke += m[d] * m[d];
  const float joint = lp - 0.5f * ke;
  float delta = joint - joint0;
  if (delta != delta) delta = -1e30f;  // NaN energy: 0 acceptance
  return Leaf{lp, logu < joint, (logu - kDivergenceDelta) < joint,
              fminf(1.0f, expf(delta))};
}

// Build the 2^j-leaf subtree from (x, m, g) at signed step eps * v.
// `draw(i, k)` is the merge uniform at leaf i, cascade position k.
template <class T, int D, class Draw>
__device__ __forceinline__ SubtreeStats build_subtree(
    const T& t, StackRow<D> (&stack)[kMaxDepth + 1], float (&x)[D],
    float (&m)[D], float (&g)[D], float eps, float v, float logu,
    float joint0, bool active, int j, Draw draw) {
  const float eps_signed = eps * v;
  const int n_leaves = 1 << j;
  SubtreeStats st{true, 0, 0.0f, 0, false};
  for (int i = 0; i < n_leaves && st.s; ++i) {
    const Leaf lf = leaf<T, D>(t, x, m, g, eps_signed, logu, joint0);
    if (active) {  // live = active & s, and s holds inside the loop
      st.n += lf.n ? 1 : 0;
      st.alpha += lf.alpha;
      st.n_alpha += 1;
      st.diverged |= !lf.s;
    }
    st.s = lf.s;

    // push the leaf row at the binary counter's height
    const int sp = __popc(i);
    StackRow<D>& row = stack[sp];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      row.first_pos[d] = x[d];
      row.first_mom[d] = m[d];
      row.prop_pos[d] = x[d];
      row.prop_grad[d] = g[d];
    }
    row.prop_logp = lf.logp;
    row.n = lf.n ? 1.0f : 0.0f;

    // merge cascade: ctz(i + 1) merges; the top (right) entry is the row
    // just written, then each merged row in turn
    const int n_merges = __ffs(i + 1) - 1;
    for (int k = 0; k < n_merges; ++k) {
      StackRow<D>& a = stack[sp - 1 - k];
      const StackRow<D>& b = stack[sp - k];
      const float u = draw(i, k);
      const float n_a = a.n, n_b = b.n;
      const bool take_b = u < n_b / fmaxf(n_a + n_b, 1.0f);
      const bool ok =
          merge_no_uturn<D>(x, m, a.first_pos, a.first_mom, 1, v);
      if (take_b) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          a.prop_pos[d] = b.prop_pos[d];
          a.prop_grad[d] = b.prop_grad[d];
        }
        a.prop_logp = b.prop_logp;
      }
      a.n = n_a + n_b;
      st.s = st.s && ok;
    }
  }
  return st;
}

}  // namespace mm
