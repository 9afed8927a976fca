// Built-in MH proposals for the fused MH kernel (Kernel 5).
//
// The JAX package traces a Proposal's `propose_dc(rng, pos)` into its
// Pallas MH body with the TPU hardware stream. Here each built-in
// symmetric proposal is a functor, selected by Proposal.cuda_functor
// (mini_mcmc_torch/ops/kernels/_build.py maps names to the ids below) and
// built per thread from Proposal.cuda_params. Its draws are Philox at
// (chain, step, draw d, 0) for coordinate d < D (philox.cuh); the plain
// twin in ops/kernels/mh_full.py reproduces them from the same words.
#pragma once

#include <stdint.h>

#include "philox.cuh"

namespace mm {

enum ProposalId : int { kIsotropicGaussian = 0, kRandomWalkInt = 1 };

// models/gaussian.py:isotropic_gaussian_proposal: x + std * N(0, 1), the
// normal from words x and y of draw d; the product is kept out of an FMA,
// so the proposal rounds as the twin's does. params: std.
struct IsotropicGaussian {
  float std;

  __device__ __forceinline__ explicit IsotropicGaussian(const float* p)
      : std(__ldg(p)) {}

  template <int D>
  __device__ __forceinline__ void propose(const float (&x)[D], float (&y)[D],
                                          uint32_t chain, uint32_t step,
                                          uint32_t k0, uint32_t k1) const {
#pragma unroll
    for (int d = 0; d < D; ++d)
      y[d] = x[d] +
             __fmul_rn(std, normal_at(chain, step, (uint32_t)d, k0, k1));
  }
};

// models/discrete.py:random_walk_int_proposal: x +- 1 by the top bit of
// word x of draw d (clear means +1, as `bits >= 0` at
// mini_mcmc_tpu/models/discrete.py:134), reflected at `lo` and, when
// `has_hi`, at `hi`. params: lo, hi, has_hi (floats, exact below 2**24).
struct RandomWalkInt {
  int32_t lo, hi;
  bool has_hi;

  __device__ __forceinline__ explicit RandomWalkInt(const float* p)
      : lo((int32_t)__ldg(p + 0)), hi((int32_t)__ldg(p + 1)),
        has_hi(__ldg(p + 2) != 0.0f) {}

  template <int D>
  __device__ __forceinline__ void propose(const int32_t (&x)[D],
                                          int32_t (&y)[D], uint32_t chain,
                                          uint32_t step, uint32_t k0,
                                          uint32_t k1) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const U32x4 w = philox4x32_10(U32x4{chain, step, (uint32_t)d, 0u}, k0,
                                    k1);
      int32_t v = x[d] + ((w.x >> 31) == 0u ? 1 : -1);
      v = max(v, lo);
      if (has_hi) v = min(v, hi);
      y[d] = v;
    }
  }
};

}  // namespace mm
