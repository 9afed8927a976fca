// Kernel 5's C entry over the built-in instances; the kernel is
// mh_multistep.cuh's (its note says what it replaces and what bounds it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mh_multistep.cuh"
#include "proposals.cuh"
#include "targets.cuh"

// The instantiated (target, proposal, state type, D, transformed) are
// those of MH_INSTANCES in ops/kernels/_build.py; any other returns
// cudaErrorInvalidValue. `transformed` selects Transformed<T, D>, whose
// params are the bijector table ahead of T's own.
extern "C" int mm_mh_multistep(const void* pos, const void* logp,
                               const void* tparams, const void* pparams,
                               int k_steps, int n_chains, int dim,
                               int target, int proposal, int state_type,
                               int transformed, uint32_t chain0,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t step0,
                               void* pos_out, void* logp_out, void* hist,
                               long long hist_sk, long long hist_sc,
                               void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::MhArgs a{pos,     logp,    tparams, pparams,  k_steps,
                     n_chains, chain0, seed_lo, seed_hi,  step0,
                     pos_out, logp_out, hist,   hist_sk,  hist_sc, stream};
#define MM_MH(T, P, PosT, D) return mm::launch_mh<T, P, PosT, D>(a)
#define MM_MH_F32(T, D)                                     \
  do {                                                      \
    if (transformed) {                                      \
      using Transformed_ = mm::Transformed<T, D>;           \
      MM_MH(Transformed_, mm::IsotropicGaussian, float, D); \
    } else {                                                \
      MM_MH(T, mm::IsotropicGaussian, float, D);            \
    }                                                       \
  } while (0)
  const bool iso = proposal == mm::kIsotropicGaussian && state_type == mm::kF32;
  if (iso && target == mm::kGaussian2D && dim == 2) {
    MM_MH_F32(mm::Gaussian2D, 2);
  } else if (iso && target == mm::kRosenbrockND && dim == 2) {
    MM_MH_F32(mm::RosenbrockND, 2);
  } else if (iso && target == mm::kRosenbrockND && dim == 3) {
    MM_MH_F32(mm::RosenbrockND, 3);
  } else if (target == mm::kPoisson && proposal == mm::kRandomWalkInt &&
             state_type == mm::kI32 && dim == 1 && !transformed) {
    MM_MH(mm::Poisson, mm::RandomWalkInt, int32_t, 1);
  }
#undef MM_MH_F32
#undef MM_MH
  return (int)cudaErrorInvalidValue;
}
