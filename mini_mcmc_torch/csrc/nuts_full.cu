// Kernel 4's C entry over the built-in instances (MM_DISPATCH); the kernel
// is nuts_full.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nuts_full.cuh"

// counter: two zeroed words of device scratch, kept by the caller for the
// (device, stream) and left zeroed by every launch: a launch on another
// stream takes another counter, or the two would steal chains. blocks:
// the grid, 0 for the resident blocks (occupancy x SMs). stats: null, or
// two zeroed uint64 that receive the lane-iterations and the leaves. grid:
// null, or four ints that receive blocks per SM, SMs, blocks launched and
// threads a block.
extern "C" int mm_nuts_step_f32(const void* pos, const void* eps,
                                const void* params, int depth_limit,
                                int max_depth, uint32_t k0, uint32_t k1,
                                uint32_t step, uint32_t chain0, int n_chains,
                                int dim, int target, int affine,
                                void* counter,
                                int blocks, void* stats, void* pos_out,
                                void* alpha, void* n_alpha, void* diverged,
                                void* depth, int device, int* grid,
                                void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (depth_limit < 0 || depth_limit > max_depth ||
      max_depth > mm::kMaxDepth || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const mm::StepArgs a{pos,      eps,     params,  depth_limit, k0,
                       k1,       step,    chain0,  n_chains,    blocks,
                       counter,  stats,   pos_out, alpha,       n_alpha,
                       diverged, depth,   device,  grid,        stream};
#define MM_LAUNCH(T, D) return mm::launch_step<T, D>(a)
  MM_DISPATCH(target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
