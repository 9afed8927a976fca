// MH proposals for the fused MH kernel (Kernel 5).
//
// The JAX package traces a Proposal's `propose_dc(rng, pos)` into its
// Pallas MH body with the TPU hardware stream. Here each built-in
// symmetric proposal is a functor, selected by Proposal.cuda_functor
// (mini_mcmc_torch/ops/kernels/_build.py maps names to the ids below) and
// built per thread from Proposal.cuda_params. A proposal at dimension D
// declares the words<D>() leading words of the step's word stream that it
// reads (philox.cuh:step_words; the kernel's accept uniform takes the next
// word) and proposes from the state and those words. The plain twin in
// ops/kernels/mh_full.py reproduces the draws from the same words.
//
// A user proposal (Proposal.cuda_source) meets the same contract as one
// functor named `Proposal`, pasted in a namespace of its own after these
// headers (it includes nothing) and compiled with the target into a
// library of its own (ops/kernels/user_density.py, the value-only table):
//
//   struct Proposal {
//     explicit Proposal(const float* params);   // Proposal.cuda_params
//     template <int D>
//     __host__ __device__ static constexpr int words();
//     template <int D>
//     void propose(const float (&x)[D], const uint32_t* w,
//                  float (&y)[D]) const;      // symmetric
//   };
//
// members __device__ __forceinline__ (words also __host__), float32
// states, drawing with mm::box_muller, mm::box_muller_pair and
// mm::unit_open of philox.cuh on the words w[0..words<D>() - 1]. On int32
// states (a discrete target's, Kernel 5's int32 instances) propose takes
// and gives int32_t (&)[D] instead, as RandomWalkInt below;
// examples/user_forms.py:INT_WALK_SOURCE is RandomWalkInt as a source. Its
// PyTorch twin, Proposal.propose_words(params, current [C, D], words
// [C, W]) -> [C, D] with Proposal.cuda_words(D) = words<D>(), must draw
// the same (models.base.validate_proposal_dc holds the two together at
// sampler construction). examples/user_forms.py:ISOTROPIC_WALK_SOURCE is
// IsotropicGaussian below written as a user source.
#pragma once

#include <stdint.h>

#include "philox.cuh"

namespace mm {

enum ProposalId : int { kIsotropicGaussian = 0, kRandomWalkInt = 1 };

// models/gaussian.py:isotropic_gaussian_proposal: x + std * N(0, 1).
// Normals 2p and 2p + 1 are the cosine and sine of box_muller_pair(w[2p],
// w[2p + 1]); the product is kept out of an FMA, so the proposal rounds as
// the twin's does. params: std.
struct IsotropicGaussian {
  float std;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 2 * ((D + 1) / 2);
  }

  __device__ __forceinline__ explicit IsotropicGaussian(const float* p)
      : std(__ldg(p)) {}

  template <int D>
  __device__ __forceinline__ void propose(const float (&x)[D],
                                          const uint32_t* w,
                                          float (&y)[D]) const {
#pragma unroll
    for (int p = 0; 2 * p < D; ++p) {
      float c, s;
      box_muller_pair(w[2 * p], w[2 * p + 1], c, s);
      y[2 * p] = x[2 * p] + __fmul_rn(std, c);
      if (2 * p + 1 < D) y[2 * p + 1] = x[2 * p + 1] + __fmul_rn(std, s);
    }
  }
};

// models/discrete.py:random_walk_int_proposal: x +- 1 by the top bit of
// word d (clear means +1, as `bits >= 0` at
// mini_mcmc_tpu/models/discrete.py:134), reflected at `lo` and, when
// `has_hi`, at `hi`. params: lo, hi, has_hi (floats, exact below 2**24).
struct RandomWalkInt {
  int32_t lo, hi;
  bool has_hi;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return D;
  }

  __device__ __forceinline__ explicit RandomWalkInt(const float* p)
      : lo((int32_t)__ldg(p + 0)), hi((int32_t)__ldg(p + 1)),
        has_hi(__ldg(p + 2) != 0.0f) {}

  template <int D>
  __device__ __forceinline__ void propose(const int32_t (&x)[D],
                                          const uint32_t* w,
                                          int32_t (&y)[D]) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      int32_t v = max(x[d] + ((w[d] >> 31) == 0u ? 1 : -1), lo);
      if (has_hi) v = min(v, hi);
      y[d] = v;
    }
  }
};

}  // namespace mm
