// Kernel 7's C entries over the built-in coordinate functors; the kernel
// and its launches are hmc_separable.cuh's (its note says what it
// replaces and what bounds it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_separable.cuh"

// Calls LAUNCH(F) for the coordinate functor `functor` by the bits of
// `flags`: bit 0 a diagonal metric, bit 1 a transform. Scaled<F> for the
// metric alone, TransformedCoord<F, scaled> for a transform; returns
// cudaErrorInvalidValue for any other id or bits.
#define MM_SEP_FUNCTOR(F, flags, LAUNCH)                                   \
  switch (flags) {                                                         \
    case 0:                                                                \
      LAUNCH(F);                                                           \
    case 1:                                                                \
      LAUNCH(mm::Scaled<F>);                                               \
    case 2:                                                                \
      LAUNCH(SEP_TRANSFORMED(F, false));                                   \
    case 3:                                                                \
      LAUNCH(SEP_TRANSFORMED(F, true));                                    \
    default:                                                               \
      return (int)cudaErrorInvalidValue;                                   \
  }
#define SEP_TRANSFORMED(F, scaled) mm::TransformedCoord<F, scaled>
#define MM_SEP_DISPATCH(functor, flags, LAUNCH)                            \
  do {                                                                     \
    switch (functor) {                                                     \
      case mm::kStandardNormal:                                            \
        MM_SEP_FUNCTOR(mm::StandardNormalCoord, flags, LAUNCH);            \
      case mm::kIsotropicGaussianCoord:                                    \
        MM_SEP_FUNCTOR(mm::IsotropicGaussianCoord, flags, LAUNCH);         \
      case mm::kSigmaTableNormal:                                          \
        MM_SEP_FUNCTOR(mm::SigmaTableNormalCoord, flags, LAUNCH);          \
      default:                                                             \
        return (int)cudaErrorInvalidValue;                                 \
    }                                                                      \
  } while (0)


// Trajectory-only form: one trajectory per chain of pos [C, D] (row-major,
// float32). `mom_in` null draws the momentum (production); otherwise it is
// the [C, D] momentum and `mom_out` receives the final one (the debug
// form). `eps` is a device float, `tables` [n_tables, D] (null without
// tables). Writes pos_out [C, D] and parts [3, C, G], G = ceil(ceil(D / 4)
// / (threads * 2)). `d0` places the rows at a D-slice of a wider state:
// pos, tables, bij and scale hold the slice's columns, and the momentum of
// coordinate d is drawn as global coordinate d0 + d (d0 a multiple of 4,
// else cudaErrorInvalidValue; 0 for a whole state). `functor` is a CoordId
// (_build.SEP_FUNCTORS), run by the bits of `flags` (MM_SEP_DISPATCH):
// Scaled<functor> for 1 (the scale the last table), TransformedCoord for
// 2 and 3, its table `bij` ([3, D] code, offset, width, then the six
// soft-saturation constants) and, for 3, the scale `scale` [D]; any other
// returns cudaErrorInvalidValue, as do
// `threads` not a multiple of 32 in [32, 256] and a grid past 2^31 - 1
// blocks.
extern "C" int mm_hmc_separable(const void* pos, const void* mom_in,
                                const void* eps, const void* params,
                                const void* tables, const void* bij,
                                const void* scale, int n_chains, int dim,
                                int n_leapfrog, int functor, int flags,
                                int threads, int vec, uint32_t chain0,
                                uint32_t d0, uint32_t seed_lo,
                                uint32_t seed_hi, uint32_t step,
                                void* pos_out, void* mom_out, void* parts,
                                void* stream) {
  const mm::SepCall c{pos,      mom_in,  nullptr,  nullptr, eps,
                      params,   tables,  bij,      scale,   n_chains,
                      dim,      n_leapfrog, threads, vec,   chain0,
                      seed_lo,  seed_hi, step,     pos_out, mom_out,
                      parts,    nullptr, nullptr,  stream,  d0};
#define MM_SEP(F) return mm::sep_trajectory<F>(c)
  MM_SEP_DISPATCH(functor, flags, MM_SEP);
#undef MM_SEP
  return (int)cudaErrorInvalidValue;
}

// Fused form: one whole step per chain. As the trajectory form, plus
// logp_in [C] (the cached density at pos) and `u_in` [C] (null: drawn);
// `mom_in` [C, D] replaces the drawn momentum (parity tests). Writes
// pos_out [C, D], logp_out [C] and alpha_out [C]; the launch's tiles must
// not exceed 16. Returns cudaErrorInvalidValue for a layout or functor the
// kernels do not take, and any error of the cluster launch.
extern "C" int mm_hmc_separable_step(
    const void* pos, const void* mom_in, const void* u_in,
    const void* logp_in, const void* eps, const void* params,
    const void* tables, const void* bij, const void* scale, int n_chains,
    int dim, int n_leapfrog, int functor, int flags, int threads, int vec,
    uint32_t chain0,
    uint32_t seed_lo, uint32_t seed_hi, uint32_t step, void* pos_out,
    void* logp_out, void* alpha_out, void* stream) {
  const mm::SepCall c{pos,      mom_in,  u_in,     logp_in, eps,
                      params,   tables,  bij,      scale,   n_chains,
                      dim,      n_leapfrog, threads, vec,   chain0,
                      seed_lo,  seed_hi, step,     pos_out, nullptr,
                      nullptr,  logp_out, alpha_out, stream};
#define MM_SEP(F) return mm::sep_step<F>(c)
  MM_SEP_DISPATCH(functor, flags, MM_SEP);
#undef MM_SEP
  return (int)cudaErrorInvalidValue;
}

// The clusters of the fused form that the current device holds at once
// (cudaOccupancyMaxActiveClusters) for this instance and layout, into
// *out; 0 means the launch cannot run there.
extern "C" int mm_hmc_separable_clusters(int functor, int flags,
                                         int threads, int n_tiles,
                                         int* out) {
  *out = 0;
#define MM_SEP(F) return mm::sep_clusters<F>(threads, n_tiles, out)
  MM_SEP_DISPATCH(functor, flags, MM_SEP);
#undef MM_SEP
  return (int)cudaErrorInvalidValue;
}
