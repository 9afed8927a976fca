// Pieces shared by the kernels: the per-chain leapfrog integrator of the
// HMC kernels, the launch shape, and the dispatch from (target id, D) to a
// template instance.
//
// Layout: one thread per chain, the chain's position, momentum and
// gradient for D <= 8 held in registers for the whole trajectory. The TPU
// kernels pack chains on the 128 lanes ([D, 8, C/8]); a CUDA thread holds
// one chain, so no packing or transpose exists here and the kernels read
// the runner's [C, D] tensors as they are.
#pragma once

// nvcc; the g++ build of Kernel 1's chain body (host_shim.h) has no runtime
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "targets.cuh"

namespace mm {

constexpr int kThreads = 128;
// the shared memory a block can have on the H100 (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

// L leapfrog steps with the cached half-step gradient (ops/hmc.py:170-190,
// ops/pallas/hmc.py:91-97): one gradient evaluation per step, at the
// functor's scalar S (float, or double in Kernel 1's float64 instances).
// L is a runtime loop, unrolled by two only: L = 192 unrolled in full
// would spill the register file.
template <class T, int D, class S = scalar_t<T>>
__device__ __forceinline__ void leapfrog(const T& t, S (&x)[D], S (&m)[D],
                                         S (&g)[D], S eps, int n_leapfrog) {
  const S half_eps = eps * S(0.5);
#pragma unroll 2
  for (int l = 0; l < n_leapfrog; ++l) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = m[d] + g[d] * half_eps;
      x[d] = x[d] + m[d] * eps;
    }
    t.template grad<D>(x, g);
#pragma unroll
    for (int d = 0; d < D; ++d) m[d] = m[d] + g[d] * half_eps;
  }
}

inline int blocks_for(int n_chains) {
  return (n_chains + kThreads - 1) / kThreads;
}

}  // namespace mm

// Calls LAUNCH(TargetType, D) for the instantiated (target, dim) pairs at
// scalar S (MM_DISPATCH: float, the instances of Kernels 1-4; Kernel 1's
// float64 entry passes double),
// the functor inside its wrappers by the bits of `affine`
// (_build.instance_flags): bit 0 the affine wrapper mm::Whitened of a
// whitened target (Target.cuda_affine), bit 1 mm::Transformed of a
// transformed one (Target.cuda_transform), both Whitened<Transformed<T>>,
// the metric on the unconstrained coordinates. Returns
// cudaErrorInvalidValue for any other pair or bits (the dims must match
// KERNEL_DIMS in ops/kernels/_build.py).
#define MM_AFFINE(affine, T, D, LAUNCH)                    \
  switch (affine) {                                        \
    case 0: LAUNCH(T, D); break;                           \
    case 1: {                                              \
      using Whitened_ = mm::Whitened<T, D>;                \
      LAUNCH(Whitened_, D);                                \
    } break;                                               \
    case 2: {                                              \
      using Transformed_ = mm::Transformed<T, D>;          \
      LAUNCH(Transformed_, D);                             \
    } break;                                               \
    case 3: {                                              \
      using Both_ = mm::Whitened<mm::Transformed<T, D>, D>; \
      LAUNCH(Both_, D);                                    \
    } break;                                               \
    default: return (int)cudaErrorInvalidValue;            \
  }

#define MM_DISPATCH_S(S, target, dim, affine, LAUNCH)          \
  do {                                                          \
    using Rosenbrock_ = mm::Builtins<S>::Rosenbrock;            \
    using Funnel_ = mm::Builtins<S>::Funnel;                    \
    using Gauss_ = mm::Builtins<S>::Gauss;                      \
    if ((target) == mm::kRosenbrockND) {                        \
      switch (dim) {                                            \
        case 2: MM_AFFINE(affine, Rosenbrock_, 2, LAUNCH); break; \
        case 3: MM_AFFINE(affine, Rosenbrock_, 3, LAUNCH); break; \
        case 4: MM_AFFINE(affine, Rosenbrock_, 4, LAUNCH); break; \
        default: return (int)cudaErrorInvalidValue;             \
      }                                                         \
    } else if ((target) == mm::kNealFunnel) {                   \
      switch (dim) {                                            \
        case 2: MM_AFFINE(affine, Funnel_, 2, LAUNCH); break;   \
        case 3: MM_AFFINE(affine, Funnel_, 3, LAUNCH); break;   \
        case 4: MM_AFFINE(affine, Funnel_, 4, LAUNCH); break;   \
        default: return (int)cudaErrorInvalidValue;             \
      }                                                         \
    } else if ((target) == mm::kGaussian2D && (dim) == 2) {     \
      MM_AFFINE(affine, Gauss_, 2, LAUNCH);                     \
    } else {                                                    \
      return (int)cudaErrorInvalidValue;                        \
    }                                                           \
  } while (0)

#define MM_DISPATCH(target, dim, affine, LAUNCH) \
  MM_DISPATCH_S(float, target, dim, affine, LAUNCH)
