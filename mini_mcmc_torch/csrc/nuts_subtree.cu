// Kernel 3: one 2^j-leaf NUTS subtree per launch.
//
// Replaces mini_mcmc_tpu/ops/pallas/nuts_subtree.py:make_pallas_subtree
// with its contract: (pos, mom, grad [C, D], logu, v, eps, joint0,
// active [C], j, seed words) -> (end_pos, end_mom, end_grad, prop_pos,
// prop_grad [C, D], prop_logp [C], n, s, alpha, n_alpha, diverged [C]).
// The tree math is nuts_tree.cuh:build_subtree.
//
// Merge uniforms come from the TPU kernel's own murmur3 counter hash over
// (seed0, seed1, i * (max_depth + 1) + k, lane), with the chain index as
// the lane: the plain twin (ops/kernels/nuts_subtree.py) and the JAX
// kernel in interpret mode draw the same numbers, so this tier is the one
// NUTS path held to the JAX package chain for chain.
//
// What bounds it on the H100: at D = 2 a leaf is ~30 f32 operations of
// leapfrog and bookkeeping plus a ~10-operation hash per merge, against 64
// bytes of device memory per chain for the whole subtree (inputs read and
// outputs written once; the stack stays in L1). So FP32 issue and the
// divergence of a warp's threads (each stops at its own U-turn) bound it,
// not bytes. One thread per chain; occupancy is left to later tuning.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "nuts_tree.cuh"

namespace {

template <class T, int D>
__global__ void __launch_bounds__(mm::kThreads) subtree_kernel(
    const float* __restrict__ pos, const float* __restrict__ mom,
    const float* __restrict__ grad, const float* __restrict__ logu,
    const float* __restrict__ v, const float* __restrict__ eps,
    const float* __restrict__ joint0, const uint8_t* __restrict__ active,
    const float* __restrict__ params, int j, int max_depth, int32_t seed0,
    int32_t seed1, int n_chains, float* __restrict__ end_pos,
    float* __restrict__ end_mom, float* __restrict__ end_grad,
    float* __restrict__ prop_pos, float* __restrict__ prop_grad,
    float* __restrict__ prop_logp, int32_t* __restrict__ n_out,
    uint8_t* __restrict__ s_out, float* __restrict__ alpha_out,
    int32_t* __restrict__ n_alpha_out, uint8_t* __restrict__ diverged_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const T t(params);
  float x[D], m[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = pos[c * D + d];
    m[d] = mom[c * D + d];
    g[d] = grad[c * D + d];
  }
  mm::StackRow<D> stack[mm::kMaxDepth + 1];
  const int events = max_depth + 1;
  const mm::SubtreeStats st = mm::build_subtree<T, D>(
      t, stack, x, m, g, eps[c], v[c], logu[c], joint0[c], active[c] != 0,
      j, [&](int i, int k) {
        return mm::hash_unit(seed0, seed1, i * events + k, (int32_t)c);
      });
#pragma unroll
  for (int d = 0; d < D; ++d) {
    end_pos[c * D + d] = x[d];
    end_mom[c * D + d] = m[d];
    end_grad[c * D + d] = g[d];
    prop_pos[c * D + d] = stack[0].prop_pos[d];
    prop_grad[c * D + d] = stack[0].prop_grad[d];
  }
  prop_logp[c] = stack[0].prop_logp;
  n_out[c] = st.n;
  s_out[c] = st.s ? 1 : 0;
  alpha_out[c] = st.alpha;
  n_alpha_out[c] = st.n_alpha;
  diverged_out[c] = st.diverged ? 1 : 0;
}

}  // namespace

extern "C" int mm_nuts_subtree_f32(
    const void* pos, const void* mom, const void* grad, const void* logu,
    const void* v, const void* eps, const void* joint0, const void* active,
    const void* params, int j, int max_depth, int32_t seed0, int32_t seed1,
    int n_chains, int dim, int target, void* end_pos, void* end_mom,
    void* end_grad, void* prop_pos, void* prop_grad, void* prop_logp,
    void* n, void* s, void* alpha, void* n_alpha, void* diverged,
    void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (j < 0 || j > max_depth || max_depth > mm::kMaxDepth)
    return (int)cudaErrorInvalidValue;
#define MM_LAUNCH(T, D)                                                    \
  subtree_kernel<T, D><<<mm::blocks_for(n_chains), mm::kThreads, 0,        \
                         (cudaStream_t)stream>>>(                          \
      (const float*)pos, (const float*)mom, (const float*)grad,            \
      (const float*)logu, (const float*)v, (const float*)eps,              \
      (const float*)joint0, (const uint8_t*)active, (const float*)params,  \
      j, max_depth, seed0, seed1, n_chains, (float*)end_pos,               \
      (float*)end_mom, (float*)end_grad, (float*)prop_pos,                 \
      (float*)prop_grad, (float*)prop_logp, (int32_t*)n, (uint8_t*)s,      \
      (float*)alpha, (int32_t*)n_alpha, (uint8_t*)diverged)
  MM_DISPATCH(target, dim, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaGetLastError();
}
