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
//
// The contract of a coordinate functor F (the built-ins below, and
// user_density.cuh:UserCoord around a user's own `Coord`, whose contract
// that header states: Target.cuda_coord_source, or the functor generated
// from the target's tile form):
//
//   static constexpr int kTables;          // tables read, 0-2
//   static constexpr bool kTransformed;    // false (TransformedCoord: true)
//   using State = ...;                     // a coordinate's constants
//   explicit F(const float* params);       // Target.cuda_params
//   State prepare(float t0, float t1) const;
//   State prepare_scaled(float t0, float t1, float s) const;  // Scaled<F>
//   float logp(float x, const State&) const;   // may be static
//   float grad(float x, const State&) const;   // d logp / dx
//
// Per-coordinate constants are hoisted: `prepare(t0, t1)` runs once per
// coordinate before the leapfrog loop and returns the functor's State,
// the only thing `grad(x, state)` and `logp(x, state)` read. The wrappers
// call logp and grad through the object, so a functor whose State holds
// its tables and scale (UserCoord) meets the same contract. All three
// functors are Gaussians, whose State is the coordinate's precision k:
// the gradient is -k x and the term -k x^2 / 2, so the leapfrog holds no
// division. Scaled<F> is F under a diagonal metric (Target.cuda_scaled),
// the scale s being the table after F's own: F::prepare_scaled folds s
// into F's State once, k = (s / sigma)^2 for a Gaussian of standard
// deviation sigma (one division and one product: fewer roundings than
// (1 / sigma)^2 s^2, which near the leapfrog's stability edge moves a
// trajectory past the float32 twin's tolerance), so the scaled leapfrog
// costs what the unscaled one does.
//
// TransformedCoord<F, kScaled> is F under a transform
// (models/transforms.py, Target.cuda_transform): a coordinate's term is
// F(x) + log|g'(y)| with x = g(y), its derivative F'(x) g'(y) + d log|g'(y)|
// / dy (targets.cuh:bij_grad, bij_logp). Its State adds the coordinate's
// bijector code, offset and width, read from a packed [3, D] table, and,
// under a diagonal metric (kScaled), the scale s, which multiplies y = s z
// ahead of the bijector: the term F(g(s z)) + log|g'(s z)|, the derivative
// s (F'(x) g'(s z) + d log|g'| / dy). The scale cannot fold into F's
// precision here, as Scaled<F> folds it.
//
// Arithmetic follows the Python forms of mini_mcmc_torch/models/gaussian.py
// (and the heterogeneous Gaussian of tests/test_pallas.py:898-942) up to
// the order of the products: k is rounded once, and the kernel contracts
// multiply-adds, so values agree with the forms to a few ulps.
#pragma once

#include <stdint.h>

#include "targets.cuh"

namespace mm {

enum CoordId : int {
  kStandardNormal = 0,
  kIsotropicGaussianCoord = 1,
  kSigmaTableNormal = 2,
};

// The three functors' shared form: a normal of precision k per coordinate.
struct GaussianCoord {
  using State = float;  // k
  static constexpr bool kTransformed = false;
  __device__ __forceinline__ static float logp(float x, float k) {
    return -0.5f * k * (x * x);
  }
  __device__ __forceinline__ static float grad(float x, float k) {
    return -(k * x);
  }
  // the precision of y -> N(s y; 0, sd^2): (s / sd)^2
  __device__ __forceinline__ static float scaled_precision(float s,
                                                           float sd) {
    const float r = s / sd;
    return r * r;
  }
};

// models/gaussian.py:standard_normal: -x^2 / 2, derivative -x (k = 1, which
// the compiler folds away).
struct StandardNormalCoord : GaussianCoord {
  static constexpr int kTables = 0;
  __device__ __forceinline__ explicit StandardNormalCoord(const float*) {}
  __device__ __forceinline__ float prepare(float, float) const {
    return 1.0f;
  }
  __device__ __forceinline__ float prepare_scaled(float, float,
                                                  float s) const {
    return s * s;
  }
};

// models/gaussian.py:isotropic_gaussian_target(std): -x^2 / (2 std^2).
// params: std.
struct IsotropicGaussianCoord : GaussianCoord {
  static constexpr int kTables = 0;
  float std_, inv_var;
  __device__ __forceinline__ explicit IsotropicGaussianCoord(const float* p)
      : std_(__ldg(p)), inv_var(1.0f / (__ldg(p) * __ldg(p))) {}
  __device__ __forceinline__ float prepare(float, float) const {
    return inv_var;
  }
  __device__ __forceinline__ float prepare_scaled(float, float,
                                                  float s) const {
    return scaled_precision(s, std_);
  }
};

// A normal with its own sigma per coordinate, read from the first table:
// -(x / sigma)^2 / 2, k = (1 / sigma)^2, one division per coordinate a
// launch.
struct SigmaTableNormalCoord : GaussianCoord {
  static constexpr int kTables = 1;
  __device__ __forceinline__ explicit SigmaTableNormalCoord(const float*) {}
  __device__ __forceinline__ float prepare(float sigma, float) const {
    return scaled_precision(1.0f, sigma);
  }
  __device__ __forceinline__ float prepare_scaled(float sigma, float,
                                                  float s) const {
    return scaled_precision(s, sigma);
  }
};

// F whitened by a diagonal metric, x = s * y with s the table after F's
// own (models/precondition.py:precondition_target adds the scale as the
// last sep_form table): logp(y) = F::logp(s y), grad(y) = s F::grad(s y),
// both through F's State with s folded in (F::prepare_scaled). No log-det
// term, as the whitened sep_form has none.
template <class F>
struct Scaled {
  static_assert(F::kTables < 2, "Scaled<F> reads F's table and the scale");
  static constexpr int kTables = F::kTables + 1;
  static constexpr bool kTransformed = false;
  using State = typename F::State;
  F f;
  __device__ __forceinline__ explicit Scaled(const float* p) : f(p) {}
  __device__ __forceinline__ State prepare(float t0, float t1) const {
    return f.prepare_scaled(t0, t1, F::kTables == 0 ? t0 : t1);
  }
  // through the object: a user functor (user_density.cuh:UserCoord)
  // keeps its tables and scale in State and evaluates F(s y) itself
  __device__ __forceinline__ float logp(float y, const State& k) const {
    return f.logp(y, k);
  }
  __device__ __forceinline__ float grad(float y, const State& k) const {
    return f.grad(y, k);
  }
};

template <class F, bool kScaled>
struct TransformedCoord {
  static constexpr int kTables = F::kTables;
  static constexpr bool kTransformed = true;
  static constexpr bool kScaledY = kScaled;
  struct State {
    typename F::State k;
    int code;
    float b, w, s;
  };
  F f;
  BijTable bt;

  // params: F's coefficients; consts: the soft-saturation constants
  __device__ __forceinline__ TransformedCoord(const float* params,
                                              const float* consts)
      : f(params), bt(consts) {}
  __device__ __forceinline__ State prepare(float t0, float t1, float code,
                                           float b, float w,
                                           float s) const {
    return State{f.prepare(t0, t1), (int)code, b, w, kScaled ? s : 1.0f};
  }
  __device__ __forceinline__ float logp(float z, const State& st) const {
    float ld = 0.0f;
    const float x = bij_logp(bt, st.code, st.b, st.w,
                             kScaled ? st.s * z : z, ld);
    return f.logp(x, st.k) + ld;
  }
  __device__ __forceinline__ float grad(float z, const State& st) const {
    float dx, dld;
    const float x = bij_grad(bt, st.code, st.b, st.w,
                             kScaled ? st.s * z : z, dx, dld);
    const float g = f.grad(x, st.k) * dx + dld;
    return kScaled ? st.s * g : g;
  }
};

// One element of the coordinate probe (ops/kernels/user_density.py:
// coord_probe, models.base.validate_coord_dc): instance F's term and
// derivative at x[i], with the i-th entries of its tables t0, t1, its
// bijector (bij [3, n]: code, offset, width) and scale, as Kernel 7
// prepares them; consts the six soft-saturation constants.
template <class F>
__device__ __forceinline__ void coord_probe_at(
    const float* x, const float* t0, const float* t1, const float* bij,
    const float* scale, int n, const float* params, const float* consts,
    int i, float* logp, float* grad) {
  if constexpr (F::kTransformed) {
    const F f(params, consts);
    const auto st = f.prepare(t0[i], t1[i], bij[i], bij[n + i],
                              bij[2 * n + i], scale[i]);
    logp[i] = f.logp(x[i], st);
    grad[i] = f.grad(x[i], st);
  } else {
    const F f(params);
    const auto st = f.prepare(t0[i], t1[i]);
    logp[i] = f.logp(x[i], st);
    grad[i] = f.grad(x[i], st);
  }
}

}  // namespace mm
