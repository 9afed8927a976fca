// Kernel 1's C entries over the built-in instances (MM_DISPATCH_S), float32
// and float64 states; the kernel is hmc_leapfrog.cuh's.
#include <cuda_runtime.h>

#include "hmc_leapfrog.cuh"


extern "C" int mm_leapfrog_f32(const void* pos, const void* mom,
                               const void* grad, const void* eps,
                               const void* params, int n_leapfrog,
                               int n_chains, int dim,
                               int target, int affine, int aligned,
                               void* pos_out,
                               void* mom_out,
                               void* logp_out, void* grad_out,
                               void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::LeapfrogArgs a{pos,      mom,     grad,     eps,
                           params,   n_leapfrog, n_chains, aligned,
                           pos_out,  mom_out, logp_out, grad_out, stream};
#define MM_LAUNCH(T, D) return mm::launch_leapfrog<T, D>(a)
  MM_DISPATCH(target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// the float64 instances: every (target, D, affine) of mm_leapfrog_f32 at
// double, states, eps, params and outputs float64
extern "C" int mm_leapfrog_f64(const void* pos, const void* mom,
                               const void* grad, const void* eps,
                               const void* params, int n_leapfrog,
                               int n_chains, int dim,
                               int target, int affine, int aligned,
                               void* pos_out,
                               void* mom_out,
                               void* logp_out, void* grad_out,
                               void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  const mm::LeapfrogArgs a{pos,      mom,     grad,     eps,
                           params,   n_leapfrog, n_chains, aligned,
                           pos_out,  mom_out, logp_out, grad_out, stream};
#define MM_LAUNCH(T, D) return mm::launch_leapfrog<T, D>(a)
  MM_DISPATCH_S(double, target, dim, affine, MM_LAUNCH);
#undef MM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
