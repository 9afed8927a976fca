// Kernel 1: the L-step leapfrog trajectory at a runtime step size.
//
// Replaces mini_mcmc_tpu/ops/pallas/hmc.py:make_pallas_leapfrog, with its
// contract: (pos, mom, grad [C, D], eps) -> (pos', mom', grad' [C, D],
// logp' [C]). Momentum comes in and no accept happens here; the caller
// (ops/hmc.py, use_pallas=True) draws momentum and accepts.
//
// What bounds it on the H100: about 45 f32 flops per leapfrog per chain
// (the Rosenbrock gradient plus the momentum and position updates) against
// 76 bytes of device memory traffic per chain (D = 3) for the whole
// trajectory. At L = 192 that is over a hundred flops per byte, far above
// the card's balance point, so the kernel is bound by FP32 issue and the
// latency of the dependent chain of operations, not by bandwidth. With one
// thread per chain, 65,536 chains are about a quarter of the threads the
// 132 SMs hold; occupancy is left to later tuning.
#include <cuda_runtime.h>

#include "hmc_common.cuh"

namespace {

template <class T, int D>
__global__ void __launch_bounds__(mm::kThreads)
    leapfrog_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mom,
                    const float* __restrict__ grad,
                    const float* __restrict__ eps,
                    const float* __restrict__ params, int n_leapfrog,
                    int n_chains, float* __restrict__ pos_out,
                    float* __restrict__ mom_out,
                    float* __restrict__ logp_out,
                    float* __restrict__ grad_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  float x[D], m[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = pos[c * D + d];
    m[d] = mom[c * D + d];
    g[d] = grad[c * D + d];
  }
  const T t(params);
  mm::leapfrog<T, D>(t, x, m, g, eps[0], n_leapfrog);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    pos_out[c * D + d] = x[d];
    mom_out[c * D + d] = m[d];
    grad_out[c * D + d] = g[d];
  }
  logp_out[c] = t.template logp<D>(x);
}

}  // namespace

extern "C" int mm_leapfrog_f32(const void* pos, const void* mom,
                               const void* grad, const void* eps,
                               const void* params, int n_leapfrog,
                               int n_chains, int dim,
                               int target, int affine, void* pos_out,
                               void* mom_out,
                               void* logp_out, void* grad_out,
                               void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
#define MM_LAUNCH(T, D)                                                    \
  leapfrog_kernel<T, D><<<mm::blocks_for(n_chains), mm::kThreads, 0,       \
                          (cudaStream_t)stream>>>(                         \
      (const float*)pos, (const float*)mom, (const float*)grad,            \
      (const float*)eps, (const float*)params, n_leapfrog, n_chains,      \
      (float*)pos_out, (float*)mom_out, (float*)logp_out, (float*)grad_out)
  MM_DISPATCH(target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
