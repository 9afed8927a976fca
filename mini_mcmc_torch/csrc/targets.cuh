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
// kernels' continuous targets, int32_t for the MH kernel's discrete ones.
#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

namespace mm {

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
        std::declval<const float (&)[D]>(), std::declval<float (&)[D]>()))>>
    : std::true_type {};

// logp at x, and its gradient into g: in one pass where T has one
template <class T, int D>
__device__ __forceinline__ float value_and_grad(const T& t,
                                                const float (&x)[D],
                                                float (&g)[D]) {
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
struct RosenbrockND {
  __device__ __forceinline__ explicit RosenbrockND(const float*) {}

  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = 0.0f;
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const float lo = x[i], hi = x[i + 1];
      const float d = hi - lo * lo;
      g[i] += 400.0f * d * lo + 2.0f * (1.0f - lo);
      g[i + 1] += -200.0f * d;
    }
  }

  template <int D>
  __device__ __forceinline__ float logp(const float (&x)[D]) const {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const float lo = x[i], hi = x[i + 1];
      const float d = hi - lo * lo;
      s += 100.0f * (d * d) + (1.0f - lo) * (1.0f - lo);
    }
    return -s;
  }
};

// models/gaussian.py:diffable_gaussian2d, the JAX package's logp_dc and
// grad_dc (mini_mcmc_tpu/models/gaussian.py:124-135) term for term.
// params: m0, m1, ic00, ic01, ic10, ic11, norm_const. Dispatched at D = 2
// only.
struct Gaussian2D {
  float m0, m1, ic00, ic01, ic10, ic11, ic_cross, nc;

  __device__ __forceinline__ explicit Gaussian2D(const float* p)
      : m0(__ldg(p + 0)), m1(__ldg(p + 1)), ic00(__ldg(p + 2)),
        ic01(__ldg(p + 3)), ic10(__ldg(p + 4)), ic11(__ldg(p + 5)),
        ic_cross(ic01 + ic10), nc(__ldg(p + 6)) {}

  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
    static_assert(D == 2, "Gaussian2D is two-dimensional");
    const float d0 = x[0] - m0, d1 = x[1] - m1;
    g[0] = -(ic00 * d0 + ic01 * d1);
    g[1] = -(ic10 * d0 + ic11 * d1);
  }

  template <int D>
  __device__ __forceinline__ float logp(const float (&x)[D]) const {
    static_assert(D == 2, "Gaussian2D is two-dimensional");
    const float d0 = x[0] - m0, d1 = x[1] - m1;
    const float quad = ic00 * d0 * d0 + ic_cross * d0 * d1 + ic11 * d1 * d1;
    return nc - 0.5f * quad;
  }
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
struct NealFunnel {
  float inv_s2;

  __device__ __forceinline__ explicit NealFunnel(const float* p)
      : inv_s2(__ldg(p)) {}

  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
    const float v = x[0], e = expf(-v);
    float ss = 0.0f;
#pragma unroll
    for (int i = 1; i < D; ++i) ss += x[i] * x[i];
    g[0] = -v * inv_s2 + 0.5f * ss * e - 0.5f * (float)(D - 1);
#pragma unroll
    for (int i = 1; i < D; ++i) g[i] = -x[i] * e;
  }

  template <int D>
  __device__ __forceinline__ float logp(const float (&x)[D]) const {
    const float v = x[0], emv = expf(-v);
    float acc = -0.5f * v * v * inv_s2 - 0.5f * (float)(D - 1) * v;
#pragma unroll
    for (int i = 1; i < D; ++i) acc = acc - 0.5f * x[i] * x[i] * emv;
    return acc;
  }
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
// (no slow-path call) in a leapfrog.
struct SoftSat {
  float a, s, inv_s;
};

struct BijTable {
  SoftSat e, g;  // exp's and sigmoid's

  __device__ __forceinline__ explicit BijTable(const float* p)
      : e{__ldg(p + 0), __ldg(p + 1), __ldg(p + 2)},
        g{__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)} {}
};

// y' and its two derivatives; `u` receives u (0 in the core) for the
// log-Jacobian. The constants come by value: a squash picked at run time
// by reference would put the table in local memory.
__device__ __forceinline__ float soft_pre(float a, float s, float inv_s,
                                          float y, float& dpre,
                                          float& dpre_ld, float& u) {
  const float ay = fabsf(y);
  if (ay <= a) {
    dpre = 1.0f;
    dpre_ld = 0.0f;
    u = 0.0f;
    return y;
  }
  u = (ay - a) * inv_s;
  const float e = expf(-2.0f * u);
  const float t = __fdividef(1.0f - e, 1.0f + e);  // tanh(u), u > 0
  const float sg = y < 0.0f ? -1.0f : 1.0f;
  dpre = (1.0f - t) * (1.0f + t);
  dpre_ld = -2.0f * t * sg * inv_s;
  return sg * (a + s * t);
}

__device__ __forceinline__ float sigmoid_of(float p) {
  return __fdividef(1.0f, 1.0f + expf(-p));
}

// x = g(y), dx/dy and d(log|dx/dy|)/dy: what a gradient needs. The
// compiler if-converts the families' branches: every lane evaluates the
// exp family's and the interval's functions, which at L = 40 on the
// all-positive separable stage measured faster than one expf a
// coordinate behind a warp vote on the saturation, and faster than the
// branch-free form with selects (PERF.md, PR 12).
__device__ __forceinline__ float bij_grad(const BijTable& bt, int code,
                                          float b, float w, float y,
                                          float& dx, float& dld) {
  if (code == 0) {
    dx = 1.0f;
    dld = 0.0f;
    return y;
  }
  float dpre, dpre_ld, u;
  if (code == 4) {
    const float p = soft_pre(bt.g.a, bt.g.s, bt.g.inv_s, y, dpre, dpre_ld,
                             u);
    const float sig = sigmoid_of(p);
    dx = w * sig * (1.0f - sig) * dpre;
    dld = (1.0f - 2.0f * sig) * dpre + dpre_ld;
    return b + w * sig;
  }
  const float p = soft_pre(bt.e.a, bt.e.s, bt.e.inv_s, y, dpre, dpre_ld, u);
  const float ex = expf(p);
  dx = w * ex * dpre;
  dld = dpre + dpre_ld;
  return b + w * ex;
}

// x = g(y), adding log|dx/dy| to `ld`: what a density needs
__device__ __forceinline__ float bij_logp(const BijTable& bt, int code,
                                          float b, float w, float y,
                                          float& ld) {
  if (code == 0) return y;
  float dpre, dpre_ld, u;
  const bool sig = code == 4;
  const float a = sig ? bt.g.a : bt.e.a;
  const float p = soft_pre(a, sig ? bt.g.s : bt.e.s,
                           sig ? bt.g.inv_s : bt.e.inv_s, y, dpre, dpre_ld,
                           u);
  // log sech^2(u) stably; 0 in the core
  const float pre_ld =
      fabsf(y) <= a
          ? 0.0f
          : 1.3862943611198906f - 2.0f * u - 2.0f * log1pf(expf(-2.0f * u));
  if (sig) {
    ld += logf(w) - p - 2.0f * log1pf(expf(-p)) + pre_ld;
    return b + w * sigmoid_of(p);
  }
  ld += p + pre_ld;
  return b + w * expf(p);
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
  static constexpr int kHead = 6;
  static constexpr int kFloats = kHead + 3 * D;
  BijTable bt;
  int code[D];
  float b[D], w[D];
  T inner;

  __device__ __forceinline__ explicit Transformed(const float* p)
      : bt(p), inner(p + kFloats) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      code[d] = (int)__ldg(p + kHead + 3 * d);
      b[d] = __ldg(p + kHead + 3 * d + 1);
      w[d] = __ldg(p + kHead + 3 * d + 2);
    }
  }

  template <int E>
  __device__ __forceinline__ void grad(const float (&y)[E],
                                       float (&g)[E]) const {
    static_assert(E == D, "a Transformed functor is built for one D");
    float x[D], dx[D], dld[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = bij_grad(bt, code[d], b[d], w[d], y[d], dx[d], dld[d]);
    }
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = gx[d] * dx[d] + dld[d];
  }

  template <int E>
  __device__ __forceinline__ float logp(const float (&y)[E]) const {
    static_assert(E == D, "a Transformed functor is built for one D");
    float x[D], ld = 0.0f;
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
  static constexpr int kTri = D * (D + 1) / 2;
  float ell[kTri];
  T inner;

  __device__ __forceinline__ explicit Whitened(const float* p)
      : inner(p + kTri) {
#pragma unroll
    for (int k = 0; k < kTri; ++k) ell[k] = __ldg(p + k);
  }

  __device__ __forceinline__ void to_x(const float (&y)[D],
                                       float (&x)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = ell[i * (i + 1) / 2] * y[0];
#pragma unroll
      for (int j = 1; j <= i; ++j) {
        acc = acc + ell[i * (i + 1) / 2 + j] * y[j];
      }
      x[i] = acc;
    }
  }

  template <int E>
  __device__ __forceinline__ void grad(const float (&y)[E],
                                       float (&g)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    float x[D], gx[D];
    to_x(y, x);
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = ell[i * (i + 1) / 2 + i] * gx[i];
#pragma unroll
      for (int j = i + 1; j < D; ++j) {
        acc = acc + ell[j * (j + 1) / 2 + i] * gx[j];
      }
      g[i] = acc;
    }
  }

  template <int E>
  __device__ __forceinline__ float logp(const float (&y)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    float x[D];
    to_x(y, x);
    return inner.template logp<D>(x);
  }

  template <int E, class I = T,
            std::enable_if_t<has_logp_and_grad<I, D>::value, int> = 0>
  __device__ __forceinline__ float logp_and_grad(const float (&y)[E],
                                                 float (&g)[E]) const {
    static_assert(E == D, "a Whitened functor is built for one D");
    float x[D], gx[D];
    to_x(y, x);
    const float lp = inner.template logp_and_grad<D>(x, gx);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = ell[i * (i + 1) / 2 + i] * gx[i];
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
  float s[D];
  T inner;

  __device__ __forceinline__ explicit WhitenedDiag(const float* p)
      : inner(p + D) {
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __ldg(p + d);
  }

  template <int E>
  __device__ __forceinline__ void grad(const float (&y)[E],
                                       float (&g)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    float x[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    inner.template grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = s[d] * gx[d];
  }

  template <int E>
  __device__ __forceinline__ float logp(const float (&y)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    return inner.template logp<D>(x);
  }

  template <int E, class I = T,
            std::enable_if_t<has_logp_and_grad<I, D>::value, int> = 0>
  __device__ __forceinline__ float logp_and_grad(const float (&y)[E],
                                                 float (&g)[E]) const {
    static_assert(E == D, "a WhitenedDiag functor is built for one D");
    float x[D], gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d] * y[d];
    const float lp = inner.template logp_and_grad<D>(x, gx);
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = s[d] * gx[d];
    return lp;
  }
};

}  // namespace mm
