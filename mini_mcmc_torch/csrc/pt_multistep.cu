// Kernel 8's C entry over the built-in instances; the kernel is
// pt_multistep.cuh's (its note says what it replaces and what bounds it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_multistep.cuh"
#include "targets.cuh"

// The instantiated (target, D, transformed) are those of PT_INSTANCES in
// ops/kernels/_build.py, for ladders of 2 to 16 rungs (PT_MAX_TEMPS); any
// other returns cudaErrorInvalidValue. `transformed` selects
// Transformed<T, D>, whose params are the bijector table ahead of T's own.
extern "C" int mm_pt_multistep(const void* pos, const void* logp,
                               const void* sa, const void* tparams,
                               const void* ladder, int n_chains, int dim,
                               int n_temps, int k_steps, int n_inner,
                               int target, int transformed, int parity0,
                               uint32_t chain0, uint32_t seed_lo,
                               uint32_t seed_hi,
                               uint32_t step0,
                               void* pos_out, void* logp_out, void* sa_out,
                               void* hist, long long hist_sk,
                               long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::PtArgs a{pos,      logp,    sa,      tparams, ladder,
                     n_chains, n_temps, k_steps, n_inner, parity0,
                     chain0,   seed_lo, seed_hi, step0,   pos_out, logp_out,
                     sa_out,   hist,    hist_sk, hist_sc, stream};
#define MM_PT_TARGET(T, D)                          \
  do {                                              \
    if (transformed) {                              \
      using Transformed_ = mm::Transformed<T, D>;   \
      return mm::launch_pt<Transformed_, D>(a);     \
    }                                               \
    return mm::launch_pt<T, D>(a);                  \
  } while (0)
  if (target == mm::kGaussian2D && dim == 2) {
    MM_PT_TARGET(mm::Gaussian2D, 2);
  } else if (target == mm::kGaussianMixture1D && dim == 1) {
    MM_PT_TARGET(mm::GaussianMixture1D, 1);
  }
#undef MM_PT_TARGET
  return (int)cudaErrorInvalidValue;
}
