// Built-in target densities for the hand-written kernels, and the metric
// and transform wrappers around any density.
//
// The JAX package traces a Target's jnp chains-on-lanes forms
// (logp_dc/grad_dc, mini_mcmc_tpu/models/base.py:97-125) into its Pallas
// bodies. CUDA cannot take a Python density, so a density reaches
// Kernels 1-4 by one of two routes: a built-in functor here, selected by
// the Target's `cuda_functor` name (mini_mcmc_torch/ops/kernels/_build.py
// maps names to the ids below), or a functor of the user's own C++
// (`Target.cuda_source`, or one generated from the target's PyTorch batch
// form), compiled into a library of its own behind mm::User
// (user_density.cuh, ops/kernels/user_density.py). The MH and tempering
// kernels (5 and 8) run either route too, the user's in a value-only
// library of its own.
//
// A functor is built once per thread from the kernel's `params` pointer
// (Target.cuda_params on the device; null for a functor without
// coefficients) and keeps its coefficients in registers. `logp` takes the
// state type of the kernels that run it: float for the HMC, NUTS and MH
// kernels' continuous targets, int32_t for the MH kernel's discrete ones,
// and double for Kernel 1's float64 instances (the JAX package's Kernel 1
// runs float64 states under jax_enable_x64). A functor of a scalar S
// declares `using Scalar = S` and takes `const S*` params; one without
// (the Poisson, the mixture, a user's int32 density) is float's. The
// continuous functors are templates on S (RosenbrockT, Gaussian2DT,
// NealFunnelT); their float instances keep the names the kernels were
// built with (RosenbrockND, Gaussian2D, NealFunnel) and the same code.
#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

namespace mm {

// The scalar of functor T: T::Scalar where it declares one, else float.
template <class T, class = void>
struct scalar_of {
  using type = float;
};
template <class T>
struct scalar_of<T, std::void_t<typename T::Scalar>> {
  using type = typename T::Scalar;
};
template <class T>
using scalar_t = typename scalar_of<T>::type;

// The functions the functors call, at float (the calls the float
// instances always made) and at double (libm's double functions: no MUFU
// exists for them, so each is a software sequence on the FP64 pipe).
__device__ __forceinline__ float exp_of(float a) { return expf(a); }
__device__ __forceinline__ double exp_of(double a) { return ::exp(a); }
__device__ __forceinline__ float log_of(float a) { return logf(a); }
__device__ __forceinline__ double log_of(double a) { return ::log(a); }
__device__ __forceinline__ float log1p_of(float a) { return log1pf(a); }
__device__ __forceinline__ double log1p_of(double a) { return ::log1p(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return ::fabs(a); }
// a / b where b is bounded away from 0 and infinity: __fdividef at float
// (no IEEE division, no slow-path call in a leapfrog), IEEE at double
__device__ __forceinline__ float div_of(float a, float b) {
  return __fdividef(a, b);
}
__device__ __forceinline__ double div_of(double a, double b) { return a / b; }

// Whether T gives its logp and gradient in one pass, logp_and_grad<D>(x,
// g) -> logp: a user density whose gradient is the dual numbers'
// (user_density.cuh), whose value is the logp, and the wrappers around
// one. The leaves of Kernels 3 and 4 then evaluate the density once;
// every other functor keeps grad and logp apart, as before.
template <class T, int D, class = void>
struct has_logp_and_grad : std::false_type {};
template <class T, int D>
struct has_logp_and_grad<
    T, D,
    std::void_t<decltype(std::declval<const T&>().template logp_and_grad<D>(
        std::declval<const scalar_t<T> (&)[D]>(),
        std::declval<scalar_t<T> (&)[D]>()))>>
    : std::true_type {};

// logp at x, and its gradient into g: in one pass where T has one
template <class T, int D, class S = scalar_t<T>>
__device__ __forceinline__ S value_and_grad(const T& t, const S (&x)[D],
                                            S (&g)[D]) {
  if constexpr (has_logp_and_grad<T, D>::value) {
    return t.template logp_and_grad<D>(x, g);
  } else {
    t.template grad<D>(x, g);
    return t.template logp<D>(x);
  }
}

enum TargetId : int {
  kRosenbrockND = 0,
  kGaussian2D = 1,
  kPoisson = 2,
  kGaussianMixture1D = 3,
  kNealFunnel = 4,
};

// models/rosenbrock.py:rosenbrock_nd, arithmetic in the JAX form's order:
// logp = -sum_i [100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2]
template <class S>
struct RosenbrockT {
  using Scalar = S;
  __device__ __forceinline__ explicit RosenbrockT(const S*) {}

  template <int D>
  __device__ __forceinline__ void grad(const S (&x)[D], S (&g)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = S(0);
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const S lo = x[i], hi = x[i + 1];
      const S d = hi - lo * lo;
      g[i] += S(400) * d * lo + S(2) * (S(1) - lo);
      g[i + 1] += S(-200) * d;
    }
  }

  template <int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S s = S(0);
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const S lo = x[i], hi = x[i + 1];
      const S d = hi - lo * lo;
      s += S(100) * (d * d) + (S(1) - lo) * (S(1) - lo);
    }
    return -s;
  }
};
struct RosenbrockND : RosenbrockT<float> {
  using RosenbrockT<float>::RosenbrockT;
};

// models/gaussian.py:diffable_gaussian2d, the JAX package's logp_dc and
// grad_dc (mini_mcmc_tpu/models/gaussian.py:124-135) term for term.
// params: m0, m1, ic00, ic01, ic10, ic11, norm_const. Dispatched at D = 2
// only.
template <class S>
struct Gaussian2DT {
  using Scalar = S;
  S m0, m1, ic00, ic01, ic10, ic11, ic_cross, nc;

  __device__ __forceinline__ explicit Gaussian2DT(const S* p)
      : m0(__ldg(p + 0)), m1(__ldg(p + 1)), ic00(__ldg(p + 2)),
        ic01(__ldg(p + 3)), ic10(__ldg(p + 4)), ic11(__ldg(p + 5)),
        ic_cross(ic01 + ic10), nc(__ldg(p + 6)) {}

  template <int D>
  __device__ __forceinline__ void grad(const S (&x)[D], S (&g)[D]) const {
    static_assert(D == 2, "Gaussian2D is two-dimensional");
    const S d0 = x[0] - m0, d1 = x[1] - m1;
    g[0] = -(ic00 * d0 + ic01 * d1);
    g[1] = -(ic10 * d0 + ic11 * d1);
  }

  template <int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    static_assert(D == 2, "Gaussian2D is two-dimensional");
    const S d0 = x[0] - m0, d1 = x[1] - m1;
    const S quad = ic00 * d0 * d0 + ic_cross * d0 * d1 + ic11 * d1 * d1;
    return nc - S(0.5) * quad;
  }
};
struct Gaussian2D : Gaussian2DT<float> {
  using Gaussian2DT<float>::Gaussian2DT;
};

// models/discrete.py:poisson_target over int32 states, in the JAX XLA
// form's order (mini_mcmc_tpu/models/discrete.py:59-63):
// logp = (k ln(lam) - lam) - lgamma(k + 1), -inf for k < 0. CUDA's lgammaf
// replaces the JAX package's Lanczos series (utils/mathx.py), which exists
// only because Mosaic cannot lower lax.lgamma; the product is kept out of
// an FMA so that the twin (torch.lgamma) rounds it the same way.
//
// lgammaf is five branches by the size of its argument, so a warp whose
// chains sit at k = 0..10 ran four of them a step (~140 issue slots).
// The block therefore fills a shared table of lgammaf(k + 1) for k <
// kTable once, and a step reads it; beyond the table it calls lgammaf.
// The values are lgammaf's own, so the density is the same function. The
// constructor synchronises the block: every thread of the block must
// build the functor. params: log_lam, lam. MH kernel only, at D = 1.
struct Poisson {
  static constexpr int kTable = 64;
  float log_lam, lam;
  const float* table;

  __device__ __forceinline__ explicit Poisson(const float* p)
      : log_lam(__ldg(p + 0)), lam(__ldg(p + 1)) {
    __shared__ float lgamma_table[kTable];
    for (int i = threadIdx.x; i < kTable; i += blockDim.x)
      lgamma_table[i] = lgammaf((float)i + 1.0f);
    __syncthreads();
    table = lgamma_table;
  }

  template <int D>
  __device__ __forceinline__ float logp(const int32_t (&k)[D]) const {
    static_assert(D == 1, "Poisson is one-dimensional");
    if (k[0] < 0) return -__int_as_float(0x7f800000);  // -inf
    const float kf = (float)k[0];
    const float lg = k[0] < kTable ? table[k[0]] : lgammaf(kf + 1.0f);
    return (__fmul_rn(kf, log_lam) - lam) - lg;
  }
};

// A two-component 1-D Gaussian mixture, the tempering stage's target of
// bench.py:858-880: logaddexp(a, b) with a = log_w0 - ((x - mu0) / s0)^2
// / 2 and b likewise, in the order of the JAX forms and of
// jnp.logaddexp (max + log1p(exp(-|a - b|)), a + b when a - b is NaN).
// Products are __fmul_rn: contracting (z * z) into the subtraction would
// round differently from the twin. params: log_w0, mu0, s0, log_w1, mu1,
// s1. Tempering kernel only, at D = 1.
struct GaussianMixture1D {
  float lw0, mu0, s0, lw1, mu1, s1;

  __device__ __forceinline__ explicit GaussianMixture1D(const float* p)
      : lw0(__ldg(p + 0)), mu0(__ldg(p + 1)), s0(__ldg(p + 2)),
        lw1(__ldg(p + 3)), mu1(__ldg(p + 4)), s1(__ldg(p + 5)) {}

  template <int D>
  __device__ __forceinline__ float logp(const float (&x)[D]) const {
    static_assert(D == 1, "GaussianMixture1D is one-dimensional");
    const float z0 = (x[0] - mu0) / s0, z1 = (x[0] - mu1) / s1;
    const float a = __fsub_rn(lw0, __fmul_rn(0.5f, __fmul_rn(z0, z0)));
    const float b = __fsub_rn(lw1, __fmul_rn(0.5f, __fmul_rn(z1, z1)));
    const float delta = a - b;
    if (isnan(delta)) return a + b;
    return fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
  }
};

// models/gaussian.py:neal_funnel, the JAX package's logp_dc term for term
// (mini_mcmc_tpu/models/gaussian.py:270-281) and the analytic gradient of
// its grad (:261-268): state [v, x_1, .., x_{D-1}], logp = -v^2 / (2
// scale^2) - (D - 1) v / 2 - sum_i x_i^2 e^-v / 2. params: 1 / scale^2.
template <class S>
struct NealFunnelT {
  using Scalar = S;
  S inv_s2;

  __device__ __forceinline__ explicit NealFunnelT(const S* p)
      : inv_s2(__ldg(p)) {}

  template <int D>
  __device__ __forceinline__ void grad(const S (&x)[D], S (&g)[D]) const {
    const S v = x[0], e = exp_of(-v);
    S ss = S(0);
#pragma unroll
    for (int i = 1; i < D; ++i) ss += x[i] * x[i];
    g[0] = -v * inv_s2 + S(0.5) * ss * e - S(0.5) * (S)(D - 1);
#pragma unroll
    for (int i = 1; i < D; ++i) g[i] = -x[i] * e;
  }

  template <int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    const S v = x[0], emv = exp_of(-v);
    S acc = S(-0.5) * v * v * inv_s2 - S(0.5) * (S)(D - 1) * v;
#pragma unroll
    for (int i = 1; i < D; ++i) acc = acc - S(0.5) * x[i] * x[i] * emv;
    return acc;
  }
};
struct NealFunnel : NealFunnelT<float> {
  using NealFunnelT<float>::NealFunnelT;
};

// The built-in functors of Kernels 1-4 at scalar S (MM_DISPATCH_S in
// hmc_common.cuh): float's are the types the float kernels always ran.
template <class S>
struct Builtins {
  using Rosenbrock = RosenbrockT<S>;
  using Gauss = Gaussian2DT<S>;
  using Funnel = NealFunnelT<S>;
};
template <>
struct Builtins<float> {
  using Rosenbrock = RosenbrockND;
  using Gauss = Gaussian2D;
  using Funnel = NealFunnel;
};

// The bijectors of models/transforms.py, x = g(y) per coordinate, in the
// closed forms of their derivatives (the JAX package takes them by AD
// through jnp.where, transforms.py:218-228). Every built-in bijector
// soft-saturates its pre-image (transforms.py:79-130): with a the core's
// half-width, s the saturation scale and u = (|y| - a) / s,
//   y' = y for |y| <= a, else sign(y) (a + s tanh(u));
//   dy'/dy = 1 in the core, else sech^2(u) = (1 - tanh u)(1 + tanh u);
//   log dy'/dy = 0 in the core, else 2 log 2 - 2u - 2 log1p(e^-2u), whose
//   derivative is -2 tanh(u) sign(y) / s.
// At |y| = a both take the core's value, as AD through jnp.where does.
// Codes (models/transforms.py:BIJ_*): 0 identity; 1-3 x = b + w exp(y')
// (positive: b = 0, w = 1; lower: b = low, w = 1; upper: b = high,
// w = -1), log|dx/dy| = y' + log dy'/dy; 4 interval, x = b + w sigmoid(y')
// with b = low, w = high - low, log|dx/dy| = log w - y' - 2 log1p(e^-y')
// + log dy'/dy. a, s and 1 / s come from the host, the float32 constants
// of models/transforms.py:_soft_saturate (~39.93 for exp, ~7.971 for
// sigmoid); the kernels multiply by 1 / s instead of dividing, and tanh is
// (1 - e) / (1 + e), e = exp(-2u), through __fdividef: no IEEE division
// (no slow-path call) in a leapfrog. Kernel 1's float64 instances run the
// same forms at double (IEEE division, libm's double exp and log1p) on
// the float64 constants of the squashes (the host gives them at double).
template <class S>
struct SoftSatT {
  S a, s, inv_s;
};
using SoftSat = SoftSatT<float>;

template <class S>
struct BijTableT {
  SoftSatT<S> e, g;  // exp's and sigmoid's

  __device__ __forceinline__ explicit BijTableT(const S* p)
      : e{__ldg(p + 0), __ldg(p + 1), __ldg(p + 2)},
        g{__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)} {}
};
using BijTable = BijTableT<float>;

// y' and its two derivatives; `u` receives u (0 in the core) for the
// log-Jacobian. The constants come by value: a squash picked at run time
// by reference would put the table in local memory.
template <class S>
__device__ __forceinline__ S soft_pre(S a, S s, S inv_s, S y, S& dpre,
                                      S& dpre_ld, S& u) {
  const S ay = abs_of(y);
  if (ay <= a) {
    dpre = S(1);
    dpre_ld = S(0);
    u = S(0);
    return y;
  }
  u = (ay - a) * inv_s;
  const S e = exp_of(S(-2) * u);
  const S t = div_of(S(1) - e, S(1) + e);  // tanh(u), u > 0
  const S sg = y < S(0) ? S(-1) : S(1);
  dpre = (S(1) - t) * (S(1) + t);
  dpre_ld = S(-2) * t * sg * inv_s;
  return sg * (a + s * t);
}

template <class S>
__device__ __forceinline__ S sigmoid_of(S p) {
  return div_of(S(1), S(1) + exp_of(-p));
}

// log 4, the constant of log sech^2(u) = 2 log 2 - 2u - 2 log1p(e^-2u)
template <class S>
__device__ __forceinline__ S log4_of();
template <>
__device__ __forceinline__ float log4_of<float>() {
  return 1.3862943611198906f;
}
template <>
__device__ __forceinline__ double log4_of<double>() {
  return 1.3862943611198906;
}

// x = g(y), dx/dy and d(log|dx/dy|)/dy: what a gradient needs. The
// compiler if-converts the families' branches: every lane evaluates the
// exp family's and the interval's functions, which at L = 40 on the
// all-positive separable stage measured faster than one expf a
// coordinate behind a warp vote on the saturation, and faster than the
// branch-free form with selects (PERF.md, PR 12).
template <class S>
__device__ __forceinline__ S bij_grad(const BijTableT<S>& bt, int code, S b,
                                      S w, S y, S& dx, S& dld) {
  if (code == 0) {
    dx = S(1);
    dld = S(0);
    return y;
  }
  S dpre, dpre_ld, u;
  if (code == 4) {
    const S p = soft_pre(bt.g.a, bt.g.s, bt.g.inv_s, y, dpre, dpre_ld, u);
    const S sig = sigmoid_of(p);
    dx = w * sig * (S(1) - sig) * dpre;
    dld = (S(1) - S(2) * sig) * dpre + dpre_ld;
    return b + w * sig;
  }
  const S p = soft_pre(bt.e.a, bt.e.s, bt.e.inv_s, y, dpre, dpre_ld, u);
  const S ex = exp_of(p);
  dx = w * ex * dpre;
  dld = dpre + dpre_ld;
  return b + w * ex;
}

// x = g(y), adding log|dx/dy| to `ld`: what a density needs
template <class S>
__device__ __forceinline__ S bij_logp(const BijTableT<S>& bt, int code, S b,
                                      S w, S y, S& ld) {
  if (code == 0) return y;
  S dpre, dpre_ld, u;
  const bool sig = code == 4;
  const S a = sig ? bt.g.a : bt.e.a;
  const S p = soft_pre(a, sig ? bt.g.s : bt.e.s,
                       sig ? bt.g.inv_s : bt.e.inv_s, y, dpre, dpre_ld, u);
  // log sech^2(u) stably; 0 in the core
  const S pre_ld =
      abs_of(y) <= a
          ? S(0)
          : log4_of<S>() - S(2) * u - S(2) * log1p_of(exp_of(S(-2) * u));
  if (sig) {
    ld += log_of(w) - p - S(2) * log1p_of(exp_of(-p)) + pre_ld;
    return b + w * sigmoid_of(p);
  }
  ld += p + pre_ld;
  return b + w * exp_of(p);
}

// The transformed target of models/transforms.py:CoordinateTransform.wrap,
// logp_y(y) = T::logp(g(y)) + sum_d log|g_d'(y_d)| around any functor T
// above, with g_y = T::grad(x) * dx/dy + dlog|dx/dy|/dy (the JAX package's
// wrap, transforms.py:371-385). Kernels 1-4 run its gradient and
// density, the MH and tempering kernels (5 and 8) its density alone (at
// D = 1 too: the mixture has no gradient, and grad is instantiated only
// where a kernel calls it). Each coordinate's bijector is a runtime code
// read with its offset and width into registers, so one instance serves
// every transform of a (T, D). params: the soft-saturation constants
// (kHead floats), each coordinate's (code, offset, width), then T's own.
template <class T, int D>
struct Transformed {
  using Scalar = scalar_t<T>;
  using S = Scalar;
  static constexpr int kHead = 6;
  static constexpr int kFloats = kHead + 3 * D;
  BijTableT<S> bt;
  int code[D];
  S b[D], w[D];
  T inner;

  __device__ __forceinline__ explicit Transformed(const S* p)
      : bt(p), inner(p + kFloats) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      code[d] = (int)__ldg(p + kHead + 3 * d);
      b[d] = __ldg(p + kHead + 3 * d + 1);
      w[d] = __ldg(p + kHead + 3 * d + 2);
    }
  }

  template <int E>
  __device__ __forceinline__ void grad(const S (&y)[E], S (&g)[E]) const {
    static_assert(E == D, "a Transformed functor is built for one D");
    S x[D], dx[D], dld[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = bij_grad(bt, code[d], b[d], w[d], y[d], dx[d], dld[d]);
    }
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = gx[d] * dx[d] + dld[d];
  }

  template <int E>
  __device__ __forceinline__ S logp(const S (&y)[E]) const {
    static_assert(E == D, "a Transformed functor is built for one D");
    S x[D], ld = S(0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = bij_logp(bt, code[d], b[d], w[d], y[d], ld);
    }
    return inner.template logp<D>(x) + ld;
  }
};

// The whitened target of models/precondition.py:precondition_target,
// logp_y(y) = logp_x(L y), around any functor T above: the kernels' CUDA
// counterpart of the JAX package's _wrap_dc_forms
// (mini_mcmc_tpu/models/precondition.py:148-209), in its order of terms:
// x_i = L_i0 y_0 + ... + L_ii y_i, and g_y_i = L_ii g_i + sum_{j>i} L_ji g_j
// (g_y = L^T g_x). A diagonal metric is L = diag(scale), whose zero
// off-diagonal terms leave x_i = s_i y_i. params: L's lower triangle row by
// row (kTri floats, held in registers), then T's own.
template <class T, int D>
struct Whitened {
  using Scalar = scalar_t<T>;
  using S = Scalar;
  static constexpr int kTri = D * (D + 1) / 2;
  S ell[kTri];
  T inner;

  __device__ __forceinline__ explicit Whitened(const S* p)
      : inner(p + kTri) {
#pragma unroll
    for (int k = 0; k < kTri; ++k) ell[k] = __ldg(p + k);
  }

  __device__ __forceinline__ void to_x(const S (&y)[D], S (&x)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      S acc = ell[i * (i + 1) / 2] * y[0];
#pragma unroll
      for (int j = 1; j <= i; ++j) {
        acc = acc + ell[i * (i + 1) / 2 + j] * y[j];
      }
      x[i] = acc;
    }
  }

  template <int E>
  __device__ __forceinline__ void grad(const S (&y)[E], S (&g)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    S x[D], gx[D];
    to_x(y, x);
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      S acc = ell[i * (i + 1) / 2 + i] * gx[i];
#pragma unroll
      for (int j = i + 1; j < D; ++j) {
        acc = acc + ell[j * (j + 1) / 2 + i] * gx[j];
      }
      g[i] = acc;
    }
  }

  template <int E>
  __device__ __forceinline__ S logp(const S (&y)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    S x[D];
    to_x(y, x);
    return inner.template logp<D>(x);
  }

  template <int E, class I = T,
            std::enable_if_t<has_logp_and_grad<I, D>::value, int> = 0>
  __device__ __forceinline__ S logp_and_grad(const S (&y)[E],
                                             S (&g)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    S x[D], gx[D];
    to_x(y, x);
    const S lp = inner.template logp_and_grad<D>(x, gx);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      S acc = ell[i * (i + 1) / 2 + i] * gx[i];
#pragma unroll
      for (int j = i + 1; j < D; ++j) {
        acc = acc + ell[j * (j + 1) / 2 + i] * gx[j];
      }
      g[i] = acc;
    }
    return lp;
  }
};

// The whitened target of a diagonal metric, x = s * y (the JAX package's
// _wrap_dc_forms diag branch, mini_mcmc_tpu/models/precondition.py:
// 164-175): logp_y(y) = T::logp(s * y), g_y = s * T::grad(s * y). Kernels
// 1-4 run it above D = 4 (models/precondition.py), where a triangle of L
// would be D (D + 1) / 2 floats of zeros and D scales. params: the D
// scales, then T's own.
template <class T, int D>
struct WhitenedDiag {
  using Scalar = scalar_t<T>;
  using S = Scalar;
  S s[D];
  T inner;

  __device__ __forceinline__ explicit WhitenedDiag(const S* p)
      : inner(p + D) {
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __ldg(p + d);
  }

  template <int E>
  __device__ __forceinline__ void grad(const S (&y)[E], S (&g)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    S x[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = s[d] * gx[d];
  }

  template <int E>
  __device__ __forceinline__ S logp(const S (&y)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    S x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    return inner.template logp<D>(x);
  }

  template <int E, class I = T,
            std::enable_if_t<has_logp_and_grad<I, D>::value, int> = 0>
  __device__ __forceinline__ S logp_and_grad(const S (&y)[E],
                                             S (&g)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    S x[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    const S lp = inner.template logp_and_grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = s[d] * gx[d];
    return lp;
  }
};

}  // namespace mm
