// Gibbs full conditionals for the fused Gibbs kernel (Kernel 6).
//
// The JAX package traces a Conditional's `sample_dc(rng, i, state)` into
// its Pallas sweep with the TPU hardware stream. Here each built-in
// conditional is a functor, selected by Conditional.cuda_functor
// (mini_mcmc_torch/ops/kernels/_build.py maps names to the ids below) and
// built per thread from Conditional.cuda_params. A conditional at
// dimension D declares the words<D>() leading words of the sweep's word
// stream that it reads (philox.cuh:step_words) and draws coordinate i from
// them given the state. The plain twin in ops/kernels/gibbs_full.py
// reproduces the draws from the same words.
//
// A user conditional (Conditional.cuda_source) meets the same contract as
// one functor named `Conditional`, pasted in a namespace of its own after
// these headers and compiled at its D into a library of its own
// (ops/kernels/user_density.py):
//
//   struct Conditional {
//     explicit Conditional(const float* params);  // cuda_params
//     template <int D>
//     __host__ __device__ static constexpr int words();
//     template <int D>
//     float sample(int i, const float (&s)[D], const uint32_t* w) const;
//   };
//
// members __device__ __forceinline__ (words also __host__): coordinate i
// given the state s, whose coordinates < i the sweep has updated, from
// the sweep's words. Its PyTorch twin, Conditional.sample_words(params,
// i, states [C, D], words [C, W]) -> [C] with Conditional.cuda_words(D) =
// words<D>(), must draw the same (models.base.validate_conditional_dc).
// examples/user_forms.py:MIXTURE_CONDITIONAL_SOURCE is GaussianMixture
// below written as a user source.
#pragma once

#include <stdint.h>

#include "philox.cuh"

namespace mm {

enum ConditionalId : int { kGaussianMixture = 0 };

// models/mixture.py:gaussian_mixture_conditional over [x, z], in the JAX
// form's order (mini_mcmc_tpu/models/mixture.py:26-29,55-65):
//   i = 0: x = mu_z + sigma_z * N(0, 1), the normal box_muller(w[0], w[1]);
//   i = 1: z = [u < p1 / (p0 + p1)] with 0.5 when p0 + p1 underflows to 0,
//          u from word 2; p_c = pi_c * coeff_c * exp(-(x - mu_c)^2 / 2var_c).
// expf and the division are the full-precision ones (no -use_fast_math),
// and the products are kept out of FMAs (__fmul_rn), so each value rounds
// as the twin's does: the densities underflow for far x, and `u < p`
// flips on one ulp.
// params: mu0, sigma0, mu1, sigma1, pi0, 1 - pi0, coeff0, coeff1, 2 var0,
// 2 var1 (models/mixture.py computes the last five in double precision).
struct GaussianMixture {
  float mu0, sigma0, mu1, sigma1, pi0, pi1, coeff0, coeff1, two_var0,
      two_var1;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 3;
  }

  __device__ __forceinline__ explicit GaussianMixture(const float* p)
      : mu0(__ldg(p + 0)), sigma0(__ldg(p + 1)), mu1(__ldg(p + 2)),
        sigma1(__ldg(p + 3)), pi0(__ldg(p + 4)), pi1(__ldg(p + 5)),
        coeff0(__ldg(p + 6)), coeff1(__ldg(p + 7)), two_var0(__ldg(p + 8)),
        two_var1(__ldg(p + 9)) {}

  template <int D>
  __device__ __forceinline__ float sample(int i, const float (&s)[D],
                                          const uint32_t* w) const {
    static_assert(D == 2, "the mixture's state is [x, z]");
    if (i == 0) {
      const bool low = s[1] < 0.5f;
      const float mu = low ? mu0 : mu1;
      const float sigma = low ? sigma0 : sigma1;
      return mu + __fmul_rn(sigma, box_muller(w[0], w[1]));
    }
    const float d0 = s[0] - mu0, d1 = s[0] - mu1;
    const float p0 =
        __fmul_rn(pi0, coeff0 * expf(-__fmul_rn(d0, d0) / two_var0));
    const float p1 =
        __fmul_rn(pi1, coeff1 * expf(-__fmul_rn(d1, d1) / two_var1));
    const float total = p0 + p1;
    const float prob_z1 = total > 0.0f ? p1 / total : 0.5f;
    return unit_open(w[2]) < prob_z1 ? 1.0f : 0.0f;
  }
};

}  // namespace mm
