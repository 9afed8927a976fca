// Kernel 6's C entry over the built-in instances; the kernel is
// gibbs_multistep.cuh's (its note says what it replaces and what bounds
// it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "conditionals.cuh"
#include "gibbs_multistep.cuh"

// The instantiated (conditional, D) are those of GIBBS_INSTANCES in
// ops/kernels/_build.py; any other returns cudaErrorInvalidValue.
extern "C" int mm_gibbs_multistep(const void* pos, const void* params,
                                  int k_steps, int n_chains, int dim,
                                  int conditional, uint32_t chain0,
                                  uint32_t seed_lo, uint32_t seed_hi,
                                  uint32_t step0, void* pos_out, void* hist,
                                  long long hist_sk, long long hist_sc,
                                  void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::GibbsArgs a{pos,     params,  k_steps, n_chains, chain0,
                        seed_lo, seed_hi, step0,   pos_out,  hist,
                        hist_sk, hist_sc, stream};
  if (conditional == mm::kGaussianMixture && dim == 2) {
    return mm::launch_gibbs<mm::GaussianMixture, 2>(a);
  }
  return (int)cudaErrorInvalidValue;
}
