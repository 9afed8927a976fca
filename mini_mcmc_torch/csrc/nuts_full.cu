// Kernel 4: a whole NUTS step per launch.
//
// Replaces mini_mcmc_tpu/ops/pallas/nuts_full.py:make_pallas_nuts_step
// with its contract: (pos [C, D], eps [C], depth_limit, key) ->
// (new_pos [C, D], alpha, n_alpha, diverged, depth [C] f32). Per chain
// (reference nuts.rs:550-674): momentum ~ N(0, 1), the slice
// logu = joint - Exp(1), then the doubling loop: a fair-coin direction,
// the 2^j-leaf subtree from that end of the trajectory
// (nuts_tree.cuh:build_subtree, shared with Kernel 3), the progressive
// accept u < min(1, n' / n) and the U-turn check between the trajectory's
// ends. Dual averaging stays outside, in PyTorch, as it stays in XLA.
//
// Draws are Philox4x32-10 (philox.cuh) at (chain, step, draw, sub-draw)
// under the run's key, replacing the TPU hardware stream: every draw is a
// function of its place in the run, so the plain twin
// (ops/kernels/nuts_full.py) reproduces the kernel's draws exactly and the
// result depends neither on the grid nor on early exit.
//
// Each thread runs its own doubling loop to its own stop or to
// depth_limit. A warp runs in lockstep, so a warp pays for its deepest
// chain: the reported `depth` is the warp's (__reduce_max_sync), and the
// caller's leapfrog count 2^depth - 1 is the per-warp cost (the TPU kernel
// reports per 8,192-chain grid block).
//
// What bounds it on the H100: device memory sees 16 bytes in and 24 out
// per chain per step at D = 2; the work is ~30 f32 operations per leaf,
// ~70 integer operations per Philox draw, and the divergent doubling loops
// of a warp's threads. FP32/INT32 issue and warp divergence bound it, not
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "nuts_tree.cuh"
#include "philox.cuh"

namespace {

constexpr uint32_t kMergeDraw = 0x10000u;

template <class T, int D>
__global__ void __launch_bounds__(mm::kThreads) nuts_step_kernel(
    const float* __restrict__ pos, const float* __restrict__ eps_in,
    const float* __restrict__ params, int depth_limit, int max_depth,
    uint32_t k0, uint32_t k1, uint32_t step, uint32_t chain0, int n_chains,
    float* __restrict__ pos_out, float* __restrict__ alpha_out,
    float* __restrict__ n_alpha_out, float* __restrict__ diverged_out,
    float* __restrict__ depth_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = c < n_chains;  // the tail's threads join the warp max
  const T t(params);
  const uint32_t chain = chain0 + (uint32_t)c;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = valid ? pos[c * D + d] : 0.0f;
  const float eps = valid ? eps_in[c] : 0.0f;

  float g[D], mom0[D];
  t.template grad<D>(x, g);
  const float lp0 = t.template logp<D>(x);
  float ke0 = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mom0[d] = mm::normal_at(chain, step, (uint32_t)d, k0, k1);
    ke0 += mom0[d] * mom0[d];
  }
  const float joint0 = lp0 - 0.5f * ke0;
  // logu = joint - Exp(1), Exp(1) = -ln U (nuts.rs:563-564)
  const float logu =
      joint0 + logf(mm::uniform_at(chain, step, (uint32_t)D, k0, k1));

  float x_m[D], m_m[D], g_m[D], x_p[D], m_p[D], g_p[D], sel[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x_m[d] = x_p[d] = sel[d] = x[d];
    m_m[d] = m_p[d] = mom0[d];
    g_m[d] = g_p[d] = g[d];
  }
  int n = 1;
  bool s = valid;
  float alpha = 0.0f;
  int n_alpha = 0;
  bool diverged = false;
  int j = 0;
  mm::StackRow<D> stack[mm::kMaxDepth + 1];
  const int events = max_depth + 1;

  for (; j < depth_limit && s; ++j) {
    const uint32_t dj = (uint32_t)(D + 1 + 2 * j);
    const float v =
        mm::uniform_at(chain, step, dj, k0, k1) < 0.5f ? -1.0f : 1.0f;
    float xs[D], ms[D], gs[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xs[d] = v < 0.0f ? x_m[d] : x_p[d];
      ms[d] = v < 0.0f ? m_m[d] : m_p[d];
      gs[d] = v < 0.0f ? g_m[d] : g_p[d];
    }
    const uint32_t merge_draw = kMergeDraw + (uint32_t)j;
    const mm::SubtreeStats st = mm::build_subtree<T, D>(
        t, stack, xs, ms, gs, eps, v, logu, joint0, true, j,
        [&](int i, int k) {
          return mm::uniform_at(chain, step, merge_draw, k0, k1,
                                (uint32_t)(i * events + k));
        });
    // s holds here: the end of the trajectory on side v moves
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (v < 0.0f) {
        x_m[d] = xs[d];
        m_m[d] = ms[d];
        g_m[d] = gs[d];
      } else {
        x_p[d] = xs[d];
        m_p[d] = ms[d];
        g_p[d] = gs[d];
      }
    }
    // progressive accept u < min(1, n' / n) (nuts.rs:656-663)
    const float ratio = (float)st.n / (float)n;
    const float u2 = mm::uniform_at(chain, step, dj + 1u, k0, k1);
    if (st.s && u2 < fminf(1.0f, ratio)) {
#pragma unroll
      for (int d = 0; d < D; ++d) sel[d] = stack[0].prop_pos[d];
    }
    n += st.n;
    float dot_m = 0.0f, dot_p = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float dd = x_p[d] - x_m[d];
      dot_m += dd * m_m[d];
      dot_p += dd * m_p[d];
    }
    alpha = st.alpha;
    n_alpha = st.n_alpha;
    diverged |= st.diverged;
    s = st.s && dot_m >= 0.0f && dot_p >= 0.0f;
  }

  const int warp_depth = __reduce_max_sync(0xFFFFFFFFu, j);
  if (!valid) return;
#pragma unroll
  for (int d = 0; d < D; ++d) pos_out[c * D + d] = sel[d];
  alpha_out[c] = alpha;
  n_alpha_out[c] = (float)n_alpha;
  diverged_out[c] = diverged ? 1.0f : 0.0f;
  depth_out[c] = (float)warp_depth;
}

}  // namespace

extern "C" int mm_nuts_step_f32(const void* pos, const void* eps,
                                const void* params, int depth_limit,
                                int max_depth, uint32_t k0, uint32_t k1,
                                uint32_t step, uint32_t chain0, int n_chains,
                                int dim, int target, void* pos_out,
                                void* alpha, void* n_alpha, void* diverged,
                                void* depth, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (depth_limit < 0 || depth_limit > max_depth ||
      max_depth > mm::kMaxDepth)
    return (int)cudaErrorInvalidValue;
#define MM_LAUNCH(T, D)                                                    \
  nuts_step_kernel<T, D><<<mm::blocks_for(n_chains), mm::kThreads, 0,      \
                           (cudaStream_t)stream>>>(                        \
      (const float*)pos, (const float*)eps, (const float*)params,          \
      depth_limit, max_depth, k0, k1, step, chain0, n_chains,              \
      (float*)pos_out, (float*)alpha, (float*)n_alpha, (float*)diverged,   \
      (float*)depth)
  MM_DISPATCH(target, dim, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaGetLastError();
}
