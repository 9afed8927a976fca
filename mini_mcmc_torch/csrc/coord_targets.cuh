// Coordinate functors of the separable HMC kernel (hmc_separable.cu).
//
// The JAX package's separable tier traces a Target's sep_form, a density
// over coordinate slices with per-coordinate tables, and differentiates it
// inside each [bc, bd] tile (mini_mcmc_tpu/ops/pallas/hmc_bigd.py:134-167).
// Here the density is elementwise by construction: a functor gives one
// coordinate's term f(x_d; tab_d) and its derivative, where tab_d is that
// coordinate's entry of the target's one table (kTables = 1) or unused
// (kTables = 0). The Target names its functor in `cuda_functor`;
// mini_mcmc_torch/ops/kernels/_build.py:SEP_FUNCTORS maps names to the ids
// below and to the table count. The kernel's sums over coordinates give
// logp, so a functor carries no constant that is not per coordinate.
//
// Arithmetic follows the Python forms of mini_mcmc_torch/models/gaussian.py
// (and the heterogeneous Gaussian of tests/test_pallas.py:898-942); the
// kernel contracts multiply-adds, so values agree to about an ulp.
#pragma once

#include <stdint.h>

namespace mm {

enum CoordId : int {
  kStandardNormal = 0,
  kIsotropicGaussianCoord = 1,
  kSigmaTableNormal = 2,
};

// models/gaussian.py:standard_normal: -x^2 / 2, derivative -x.
struct StandardNormalCoord {
  static constexpr int kTables = 0;
  __device__ __forceinline__ explicit StandardNormalCoord(const float*) {}
  __device__ __forceinline__ float logp(float x, float) const {
    return -0.5f * (x * x);
  }
  __device__ __forceinline__ float grad(float x, float) const { return -x; }
};

// models/gaussian.py:isotropic_gaussian_target(std): -x^2 / (2 std^2).
// params: std.
struct IsotropicGaussianCoord {
  static constexpr int kTables = 0;
  float inv_var;
  __device__ __forceinline__ explicit IsotropicGaussianCoord(const float* p)
      : inv_var(1.0f / (__ldg(p) * __ldg(p))) {}
  __device__ __forceinline__ float logp(float x, float) const {
    return -0.5f * (x * x) * inv_var;
  }
  __device__ __forceinline__ float grad(float x, float) const {
    return -x * inv_var;
  }
};

// A normal with its own sigma per coordinate, read from the one table:
// -(x / s)^2 / 2, derivative -(x / s) / s. The diag metric of
// models/precondition.py:241-250 composes into this form.
struct SigmaTableNormalCoord {
  static constexpr int kTables = 1;
  __device__ __forceinline__ explicit SigmaTableNormalCoord(const float*) {}
  __device__ __forceinline__ float logp(float x, float s) const {
    const float z = x / s;
    return -0.5f * (z * z);
  }
  __device__ __forceinline__ float grad(float x, float s) const {
    return -(x / s) / s;
  }
};

}  // namespace mm
