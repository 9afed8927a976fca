// Kernel 3's C entry over the built-in instances (MM_DISPATCH); the kernel
// is nuts_subtree.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nuts_subtree.cuh"

// v: int32 directions (+-1). grid: null, or three ints that receive blocks
// per SM at this j, SMs and blocks launched.
extern "C" int mm_nuts_subtree_f32(
    const void* pos, const void* mom, const void* grad, const void* logu,
    const void* v, const void* eps, const void* joint0, const void* active,
    const void* params, int j, int max_depth, int32_t seed0, int32_t seed1,
    uint32_t chain0, int n_chains, int dim, int target, int affine,
    void* end_pos, void* end_mom, void* end_grad, void* prop_pos,
    void* prop_grad, void* prop_logp, void* n, void* s, void* alpha,
    void* n_alpha, void* diverged, int device, int* grid, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (j < 0 || j > max_depth || max_depth > mm::kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const mm::SubtreeArgs a{pos,       mom,      grad,     logu,      v,
                          eps,       joint0,   active,   params,    j,
                          max_depth, seed0,    seed1,    chain0,    n_chains,
                          end_pos,   end_mom,  end_grad, prop_pos,  prop_grad,
                          prop_logp, n,        s,        alpha,     n_alpha,
                          diverged,  device,   grid,     stream};
#define MM_LAUNCH(T, D) return mm::launch_subtree<T, D>(a)
  MM_DISPATCH(target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
