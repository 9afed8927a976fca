// Kernel 1: the L-step leapfrog trajectory at a runtime step size.
//
// The kernel template and its launch, shared by the built-in library
// (hmc_leapfrog.cu, every instance of MM_DISPATCH) and the per-density
// libraries of user targets (ops/kernels/user_density.py).
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
//
// The scalar S is the functor's (targets.cuh:scalar_t): float, or double
// in the float64 instances (mm_leapfrog_f64; the JAX kernel takes the
// state's dtype and runs float64 under jax_enable_x64). The H100 issues
// FP64 at half its FP32 rate and has no MUFU at double, so a float64
// trajectory is bound by the FP64 pipe: the Rosenbrock step's ~45 flops
// at 64 lanes an SM, and each exp or log1p of a funnel or a bijector a
// libm sequence of some twenty FP64 operations.
#pragma once

#include <cuda_runtime.h>

#include "hmc_common.cuh"

namespace mm {

template <class T, int D, class S = scalar_t<T>>
__global__ void __launch_bounds__(kThreads)
    leapfrog_kernel(const S* __restrict__ pos,
                    const S* __restrict__ mom,
                    const S* __restrict__ grad,
                    const S* __restrict__ eps,
                    const S* __restrict__ params, int n_leapfrog,
                    int n_chains, S* __restrict__ pos_out,
                    S* __restrict__ mom_out,
                    S* __restrict__ logp_out,
                    S* __restrict__ grad_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  S x[D], m[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = pos[c * D + d];
    m[d] = mom[c * D + d];
    g[d] = grad[c * D + d];
  }
  const T t(params);
  leapfrog<T, D>(t, x, m, g, eps[0], n_leapfrog);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    pos_out[c * D + d] = x[d];
    mom_out[c * D + d] = m[d];
    grad_out[c * D + d] = g[d];
  }
  logp_out[c] = t.template logp<D>(x);
}


struct LeapfrogArgs {
  const void *pos, *mom, *grad, *eps, *params;
  int n_leapfrog, n_chains;
  void *pos_out, *mom_out, *logp_out, *grad_out;
  void* stream;
};

template <class T, int D>
int launch_leapfrog(const LeapfrogArgs& a) {
  using S = scalar_t<T>;
  leapfrog_kernel<T, D><<<blocks_for(a.n_chains), kThreads, 0,
                          (cudaStream_t)a.stream>>>(
      (const S*)a.pos, (const S*)a.mom, (const S*)a.grad, (const S*)a.eps,
      (const S*)a.params, a.n_leapfrog, a.n_chains, (S*)a.pos_out,
      (S*)a.mom_out, (S*)a.logp_out, (S*)a.grad_out);
  return (int)cudaGetLastError();
}

}  // namespace mm
