// Coordinate functors of the separable HMC kernel (hmc_separable.cu).
//
// The JAX package's separable tier traces a Target's sep_form, a density
// over coordinate slices with per-coordinate tables, and differentiates it
// inside each [bc, bd] tile (mini_mcmc_tpu/ops/pallas/hmc_bigd.py:134-167).
// Here the density is elementwise by construction: a functor gives one
// coordinate's term f(x_d; t0_d, t1_d) and its derivative, where t0_d and
// t1_d are that coordinate's entries of the target's first and second
// tables, read as far as kTables says (unused ones are 1). The Target
// names its functor in `cuda_functor`;
// mini_mcmc_torch/ops/kernels/_build.py:SEP_FUNCTORS maps names to the ids
// below and to the table count. The kernel's sums over coordinates give
// logp, so a functor carries no constant that is not per coordinate.
// Scaled<F> is F under a diagonal metric (Target.cuda_scaled): the scale
// is the table after F's own.
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
  __device__ __forceinline__ float logp(float x, float, float) const {
    return -0.5f * (x * x);
  }
  __device__ __forceinline__ float grad(float x, float, float) const {
    return -x;
  }
};

// models/gaussian.py:isotropic_gaussian_target(std): -x^2 / (2 std^2).
// params: std.
struct IsotropicGaussianCoord {
  static constexpr int kTables = 0;
  float inv_var;
  __device__ __forceinline__ explicit IsotropicGaussianCoord(const float* p)
      : inv_var(1.0f / (__ldg(p) * __ldg(p))) {}
  __device__ __forceinline__ float logp(float x, float, float) const {
    return -0.5f * (x * x) * inv_var;
  }
  __device__ __forceinline__ float grad(float x, float, float) const {
    return -x * inv_var;
  }
};

// A normal with its own sigma per coordinate, read from the first table:
// -(x / s)^2 / 2, derivative -(x / s) / s.
struct SigmaTableNormalCoord {
  static constexpr int kTables = 1;
  __device__ __forceinline__ explicit SigmaTableNormalCoord(const float*) {}
  __device__ __forceinline__ float logp(float x, float s, float) const {
    const float z = x / s;
    return -0.5f * (z * z);
  }
  __device__ __forceinline__ float grad(float x, float s, float) const {
    return -(x / s) / s;
  }
};

// F whitened by a diagonal metric, x = s * y with s the table after F's
// own (models/precondition.py:precondition_target adds the scale as the
// last sep_form table): logp(y) = F::logp(s y), grad(y) = s F::grad(s y).
// No log-det term, as the whitened sep_form has none.
template <class F>
struct Scaled {
  static_assert(F::kTables < 2, "Scaled<F> reads F's table and the scale");
  static constexpr int kTables = F::kTables + 1;
  F f;
  __device__ __forceinline__ explicit Scaled(const float* p) : f(p) {}
  __device__ __forceinline__ static float scale(float t0, float t1) {
    return F::kTables == 0 ? t0 : t1;
  }
  __device__ __forceinline__ float logp(float y, float t0, float t1) const {
    return f.logp(y * scale(t0, t1), t0, t1);
  }
  __device__ __forceinline__ float grad(float y, float t0, float t1) const {
    const float s = scale(t0, t1);
    return f.grad(y * s, t0, t1) * s;
  }
};

}  // namespace mm
