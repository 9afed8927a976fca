// User densities inside Kernels 1-5 and 8: the adapter mm::User<F> and
// the dual numbers of its derived gradient; user coordinate functors
// inside Kernel 7: mm::UserCoord<F>.
//
// Counterpart of the JAX package's Target.dc_forms
// (mini_mcmc_tpu/models/base.py:97-125): there a Python density is traced
// into the Pallas bodies; here it is C++ compiled into a library of its
// own per (density, D, wrappers) by ops/kernels/user_density.py. The C++
// is Target.cuda_source, written by hand, or generated from the target's
// PyTorch batch form (user_density.py:derive_logp_dc).
//
// The contract of a source: it defines one functor named `Density`,
//
//   struct Density {
//     explicit Density(const float* params);  // Target.cuda_params
//     template <class S, int D>
//     S logp(const S (&x)[D]) const;          // S = float or mm::Dual<D>
//     template <int D>                        // optional
//     void grad(const float (&x)[D], float (&g)[D]) const;
//   };
//
// each member __device__ __forceinline__. The source is pasted inside a
// namespace of its own after this header, so it includes nothing; it does
// its arithmetic with + - * /, unary minus and mixed float operands, and
// the functions below (mm::exp, mm::log, mm::log1p, mm::expm1, mm::sqrt,
// mm::pow with a float exponent, mm::tanh, mm::sin, mm::cos, mm::abs,
// mm::fmin, mm::fmax, mm::logaddexp), which take a float or a Dual alike,
// and reads its
// coefficients with __ldg. A value that branches on the state reads
// mm::value(s) (the float of either type). logp must treat the
// coordinates of one chain only: each thread is one chain.
//
// mm::User<F> meets the functor contract of targets.cuh, so Whitened,
// WhitenedDiag, Transformed and the four kernels take it unchanged. Its
// grad is F::grad where the source defines one (found at compile time),
// else forward-mode AD: F::logp on Dual<D> values seeded with the unit
// tangents, the gradient the D tangents of the result (the counterpart of
// derive_grad_dc, base.py:188-211). Every seed is a compile-time constant
// and the kernels unroll the density, so each Dual's mask of live tangents
// folds (see Dual): each operation costs the tangents its operands really
// carry.
//
// The MH and tempering kernels (5 and 8) read the value alone: a target
// used only by them compiles User<F>::logp at S = float, in a value-only
// library (user_density.py) with no dual numbers.
//
// Float64 states (Kernel 1 alone, as in the JAX package): the library
// compiles the source with each `float` keyword read as `double` (its
// params pointer, its gradient and its locals) inside mm::UserS<F,
// double>, and `mm::` inside the source names mm::f64, the same
// functions at double and on Dual<D, double>. Params, metric and bijector
// tables reach it as doubles. A literal with the `f` suffix stays a float
// constant: it compiles, but it caps the density's precision at float's
// (0.1f is 0.1 to 7 digits); write float64 sources with plain literals.
// validate_dc holds a float64 instance to rtol and atol 1e-10
// (models/base.py:F64_DC_TOL), so such a source is refused there.
//
// Int32 states (Kernel 5 alone, mini_mcmc_tpu/ops/pallas/mh_full.py:22-23):
// a discrete density is value-only and keeps a float logp,
//
//   struct Density {
//     explicit Density(const float* params);
//     template <int D>
//     float logp(const int32_t (&k)[D]) const;  // -inf off the support
//   };
//
// as targets.cuh:Poisson, and may call mm::lgamma besides the functions
// below. It runs as it is (no adapter), beside a built-in or user int32
// proposal (proposals.cuh), and takes no transform.
//
// The same source compiles for the host under host_shim.h, which the CPU
// tests alone use.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "targets.cuh"

namespace mm {

// A value of type V (float, or double in Kernel 1's float64 instances)
// and its N tangents, with the mask of the tangents that may be nonzero:
// an operation touches only those its operands carry. Without
// -use_fast_math the compiler may not fold 0 * x or 0 + x (IEEE signs and
// NaNs), so zero tangents would each cost their arithmetic; the masks are
// integers, which it folds: seeded with the unit vectors and unrolled, a
// density's masks are compile-time constants and every test on them goes.
// A tangent outside the mask holds 0.
template <int N, class V = float>
struct Dual {
  static_assert(N >= 1 && N <= 32, "a 32-bit mask of tangents");
  V v;
  V d[N];
  uint32_t nz;

  __device__ __forceinline__ Dual() : v(V(0)), nz(0u) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = V(0);
  }
  // a constant: no tangents (so `S acc = 0.0f;` holds for either type)
  __device__ __forceinline__ Dual(V c) : v(c), nz(0u) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = V(0);
  }

  __device__ __forceinline__ bool has(int i) const {
    return (nz >> i) & 1u;
  }
};

// V where it is not deduced: the constant operand of a mixed operation
// converts to the Dual's scalar (a float literal in a double instance)
template <class V>
struct same_type {
  using type = V;
};
template <class V>
using nd_t = typename same_type<V>::type;

// f(a) with f'(a) = `slope`: the chain rule of every unary function
template <int N, class V>
__device__ __forceinline__ Dual<N, V> chain(const Dual<N, V>& a, V value,
                                            V slope) {
  Dual<N, V> r;
  r.v = value;
  r.nz = a.nz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i)) r.d[i] = a.d[i] * slope;
  }
  return r;
}

template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator-(const Dual<N, V>& a) {
  return chain(a, -a.v, V(-1));
}

template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator+(const Dual<N, V>& a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r;
  r.v = a.v + b.v;
  r.nz = a.nz | b.nz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i) && b.has(i)) {
      r.d[i] = a.d[i] + b.d[i];
    } else if (a.has(i)) {
      r.d[i] = a.d[i];
    } else if (b.has(i)) {
      r.d[i] = b.d[i];
    }
  }
  return r;
}

template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator-(const Dual<N, V>& a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r;
  r.v = a.v - b.v;
  r.nz = a.nz | b.nz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i) && b.has(i)) {
      r.d[i] = a.d[i] - b.d[i];
    } else if (a.has(i)) {
      r.d[i] = a.d[i];
    } else if (b.has(i)) {
      r.d[i] = -b.d[i];
    }
  }
  return r;
}

template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator*(const Dual<N, V>& a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r;
  r.v = a.v * b.v;
  r.nz = a.nz | b.nz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i) && b.has(i)) {
      r.d[i] = a.d[i] * b.v + a.v * b.d[i];
    } else if (a.has(i)) {
      r.d[i] = a.d[i] * b.v;
    } else if (b.has(i)) {
      r.d[i] = a.v * b.d[i];
    }
  }
  return r;
}

template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator/(const Dual<N, V>& a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r;
  r.v = a.v / b.v;
  r.nz = a.nz | b.nz;
  const V inv = V(1) / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i) && b.has(i)) {
      r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
    } else if (a.has(i)) {
      r.d[i] = a.d[i] * inv;
    } else if (b.has(i)) {
      r.d[i] = -r.v * b.d[i] * inv;
    }
  }
  return r;
}

// mixed with a constant of the Dual's scalar
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator+(const Dual<N, V>& a,
                                                nd_t<V> b) {
  Dual<N, V> r = a;
  r.v = a.v + b;
  return r;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator+(nd_t<V> a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r = b;
  r.v = a + b.v;
  return r;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator-(const Dual<N, V>& a,
                                                nd_t<V> b) {
  Dual<N, V> r = a;
  r.v = a.v - b;
  return r;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator-(nd_t<V> a,
                                                const Dual<N, V>& b) {
  return chain(b, a - b.v, V(-1));
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator*(const Dual<N, V>& a,
                                                nd_t<V> b) {
  return chain(a, a.v * b, b);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator*(nd_t<V> a,
                                                const Dual<N, V>& b) {
  return chain(b, a * b.v, a);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator/(const Dual<N, V>& a,
                                                nd_t<V> b) {
  return chain(a, a.v / b, V(1) / b);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> operator/(nd_t<V> a,
                                                const Dual<N, V>& b) {
  const V v = a / b.v;
  return chain(b, v, -v / b.v);
}

template <int N, class V, class B>
__device__ __forceinline__ Dual<N, V>& operator+=(Dual<N, V>& a,
                                                  const B& b) {
  return a = a + b;
}
template <int N, class V, class B>
__device__ __forceinline__ Dual<N, V>& operator-=(Dual<N, V>& a,
                                                  const B& b) {
  return a = a - b;
}
template <int N, class V, class B>
__device__ __forceinline__ Dual<N, V>& operator*=(Dual<N, V>& a,
                                                  const B& b) {
  return a = a * b;
}
template <int N, class V, class B>
__device__ __forceinline__ Dual<N, V>& operator/=(Dual<N, V>& a,
                                                  const B& b) {
  return a = a / b;
}

// The functions of a density, on a float and on a Dual. Full-precision
// libm (the library is built without -use_fast_math, _build.NVCC_FLAGS).
// Each Dual form serves both scalars; mm::f64 below holds the double
// forms a float64 instance's source calls.
__device__ __forceinline__ float value(float a) { return a; }
template <int N, class V>
__device__ __forceinline__ V value(const Dual<N, V>& a) {
  return a.v;
}

__device__ __forceinline__ float exp(float a) { return expf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> exp(const Dual<N, V>& a) {
  const V e = exp_of(a.v);
  return chain(a, e, e);
}

__device__ __forceinline__ float log(float a) { return logf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> log(const Dual<N, V>& a) {
  return chain(a, log_of(a.v), V(1) / a.v);
}

__device__ __forceinline__ float log1p(float a) { return log1pf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> log1p(const Dual<N, V>& a) {
  return chain(a, log1p_of(a.v), V(1) / (V(1) + a.v));
}

__device__ __forceinline__ float expm1_of(float a) { return expm1f(a); }
__device__ __forceinline__ double expm1_of(double a) { return ::expm1(a); }
__device__ __forceinline__ float expm1(float a) { return expm1f(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> expm1(const Dual<N, V>& a) {
  return chain(a, expm1_of(a.v), exp_of(a.v));
}

__device__ __forceinline__ float sqrt_of(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_of(double a) { return ::sqrt(a); }
__device__ __forceinline__ float sqrt(float a) { return sqrtf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> sqrt(const Dual<N, V>& a) {
  const V r = sqrt_of(a.v);
  return chain(a, r, V(0.5) / r);
}

// a^p for a constant exponent; d/da = p a^(p - 1)
__device__ __forceinline__ float pow_of(float a, float p) {
  return powf(a, p);
}
__device__ __forceinline__ double pow_of(double a, double p) {
  return ::pow(a, p);
}
__device__ __forceinline__ float pow(float a, float p) { return powf(a, p); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> pow(const Dual<N, V>& a, nd_t<V> p) {
  return chain(a, pow_of(a.v, p), p * pow_of(a.v, p - V(1)));
}

__device__ __forceinline__ float tanh_of(float a) { return tanhf(a); }
__device__ __forceinline__ double tanh_of(double a) { return ::tanh(a); }
__device__ __forceinline__ float tanh(float a) { return tanhf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> tanh(const Dual<N, V>& a) {
  const V t = tanh_of(a.v);
  return chain(a, t, (V(1) - t) * (V(1) + t));
}

__device__ __forceinline__ float sin_of(float a) { return sinf(a); }
__device__ __forceinline__ double sin_of(double a) { return ::sin(a); }
__device__ __forceinline__ float cos_of(float a) { return cosf(a); }
__device__ __forceinline__ double cos_of(double a) { return ::cos(a); }
__device__ __forceinline__ float sin(float a) { return sinf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> sin(const Dual<N, V>& a) {
  return chain(a, sin_of(a.v), cos_of(a.v));
}

__device__ __forceinline__ float cos(float a) { return cosf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> cos(const Dual<N, V>& a) {
  return chain(a, cos_of(a.v), -sin_of(a.v));
}

// |a|, slope sign(a) (0 at 0, as torch.abs's)
__device__ __forceinline__ float abs(float a) { return fabsf(a); }
template <int N, class V>
__device__ __forceinline__ Dual<N, V> abs(const Dual<N, V>& a) {
  return chain(a, abs_of(a.v),
               a.v > V(0) ? V(1) : a.v < V(0) ? V(-1) : V(0));
}

// the smaller (larger) operand with its tangents; a tie takes the first
__device__ __forceinline__ float fmin(float a, float b) {
  return fminf(a, b);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmin(const Dual<N, V>& a,
                                           const Dual<N, V>& b) {
  return b.v < a.v ? b : a;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmin(const Dual<N, V>& a, nd_t<V> b) {
  return b < a.v ? Dual<N, V>(b) : a;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmin(nd_t<V> a, const Dual<N, V>& b) {
  return b.v < a ? b : Dual<N, V>(a);
}
__device__ __forceinline__ float fmax(float a, float b) {
  return fmaxf(a, b);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmax(const Dual<N, V>& a,
                                           const Dual<N, V>& b) {
  return b.v > a.v ? b : a;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmax(const Dual<N, V>& a, nd_t<V> b) {
  return b > a.v ? Dual<N, V>(b) : a;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> fmax(nd_t<V> a, const Dual<N, V>& b) {
  return b.v > a ? b : Dual<N, V>(a);
}

// log(exp(a) + exp(b)) as torch.logaddexp computes it: an infinite a
// equal to b gives a (so two -inf give -inf), else max + log1p(exp(-|a -
// b|)); d/da = exp(a - r), 1/2 each where both are the same infinity
template <class V>
__device__ __forceinline__ V logaddexp_of(V a, V b) {
  if (isinf(a) && a == b) return a;
  const V m = a < b ? b : a;
  return m + log1p_of(exp_of(-abs_of(a - b)));
}
__device__ __forceinline__ float logaddexp(float a, float b) {
  return logaddexp_of(a, b);
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> logaddexp(const Dual<N, V>& a,
                                                const Dual<N, V>& b) {
  Dual<N, V> r;
  r.v = logaddexp_of(a.v, b.v);
  r.nz = a.nz | b.nz;
  const bool tie = isinf(a.v) && a.v == b.v;
  const V wa = tie ? V(0.5) : exp_of(a.v - r.v);
  const V wb = tie ? V(0.5) : exp_of(b.v - r.v);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i) && b.has(i)) {
      r.d[i] = a.d[i] * wa + b.d[i] * wb;
    } else if (a.has(i)) {
      r.d[i] = a.d[i] * wa;
    } else if (b.has(i)) {
      r.d[i] = b.d[i] * wb;
    }
  }
  return r;
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> logaddexp(const Dual<N, V>& a,
                                                nd_t<V> b) {
  return logaddexp(a, Dual<N, V>(b));
}
template <int N, class V>
__device__ __forceinline__ Dual<N, V> logaddexp(nd_t<V> a,
                                                const Dual<N, V>& b) {
  return logaddexp(Dual<N, V>(a), b);
}

// log Gamma(a), for the int32 densities of the MH kernel (value only):
// CUDA's lgammaf, the function torch.lgamma computes
__device__ __forceinline__ float lgamma(float a) { return lgammaf(a); }

// The math of a float64 instance's source (user_density.py pastes it
// with `namespace mm = ::mm::f64;`): each function at double and on a
// Dual of doubles, so that a double operand beside a float literal
// converts to double unambiguously. A source's `f`-suffixed literals stay
// float constants, rounded to float before they meet a double.
namespace f64 {
template <int N>
using Dual = ::mm::Dual<N, double>;

__device__ __forceinline__ double value(double a) { return a; }
template <int N>
__device__ __forceinline__ double value(const Dual<N>& a) {
  return a.v;
}
#define MM_F64_UNARY(name, fn)                                          \
  __device__ __forceinline__ double name(double a) { return fn(a); }   \
  template <int N>                                                      \
  __device__ __forceinline__ Dual<N> name(const Dual<N>& a) {           \
    return ::mm::name(a);                                               \
  }
MM_F64_UNARY(exp, ::exp)
MM_F64_UNARY(log, ::log)
MM_F64_UNARY(log1p, ::log1p)
MM_F64_UNARY(expm1, ::expm1)
MM_F64_UNARY(sqrt, ::sqrt)
MM_F64_UNARY(tanh, ::tanh)
MM_F64_UNARY(sin, ::sin)
MM_F64_UNARY(cos, ::cos)
MM_F64_UNARY(abs, ::fabs)
#undef MM_F64_UNARY
__device__ __forceinline__ double pow(double a, double p) {
  return ::pow(a, p);
}
template <int N>
__device__ __forceinline__ Dual<N> pow(const Dual<N>& a, double p) {
  return ::mm::pow(a, p);
}
#define MM_F64_BINARY(name, fn)                                           \
  __device__ __forceinline__ double name(double a, double b) {           \
    return fn(a, b);                                                      \
  }                                                                       \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> name(const Dual<N>& a,               \
                                          const Dual<N>& b) {             \
    return ::mm::name(a, b);                                              \
  }                                                                       \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> name(const Dual<N>& a, double b) {   \
    return ::mm::name(a, b);                                              \
  }                                                                       \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> name(double a, const Dual<N>& b) {   \
    return ::mm::name(a, b);                                              \
  }
MM_F64_BINARY(fmin, ::fmin)
MM_F64_BINARY(fmax, ::fmax)
MM_F64_BINARY(logaddexp, ::mm::logaddexp_of<double>)
#undef MM_F64_BINARY
}  // namespace f64

// Whether F defines grad<D>(const S (&)[D], S (&)[D]).
template <class F, int D, class S = float, class = void>
struct has_grad : std::false_type {};
template <class F, int D, class S>
struct has_grad<F, D, S,
                std::void_t<decltype(std::declval<const F&>()
                                         .template grad<D>(
                                             std::declval<const S (&)[D]>(),
                                             std::declval<S (&)[D]>()))>>
    : std::true_type {};

// A user functor F behind the contract of targets.cuh at scalar S: float
// (mm::User<F>, every kernel's instance), or double (Kernel 1's float64
// instance: F compiled from the source with `float` read as `double`).
template <class F, class S>
struct UserS {
  using Scalar = S;
  F f;

  __device__ __forceinline__ explicit UserS(const S* p) : f(p) {}

  template <int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    return f.template logp<S, D>(x);
  }

  template <int D>
  __device__ __forceinline__ void grad(const S (&x)[D], S (&g)[D]) const {
    if constexpr (has_grad<F, D, S>::value) {
      f.template grad<D>(x, g);
    } else {
      dual_pass(x, g);
    }
  }

  // without a source gradient, the dual pass's value is the logp: the
  // leaves of Kernels 3 and 4 take both from it (targets.cuh:
  // value_and_grad)
  template <int D, std::enable_if_t<!has_grad<F, D, S>::value, int> = 0>
  __device__ __forceinline__ S logp_and_grad(const S (&x)[D],
                                             S (&g)[D]) const {
    return dual_pass(x, g);
  }

 private:
  template <int D>
  __device__ __forceinline__ S dual_pass(const S (&x)[D], S (&g)[D]) const {
    Dual<D, S> xd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      xd[i].v = x[i];
      xd[i].d[i] = S(1);
      xd[i].nz = 1u << i;
    }
    const Dual<D, S> r = f.template logp<Dual<D, S>, D>(xd);
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = r.has(i) ? r.d[i] : S(0);
    return r.v;
  }
};

template <class F>
struct User : UserS<F, float> {
  using UserS<F, float>::UserS;
};

// One chain of the validation probe: the instance's logp and gradient at
// x (the entries mm_user_probe of a per-density library, and of its host
// build for the tests), at the instance's scalar.
template <class T, int D, class S = scalar_t<T>>
__device__ __forceinline__ S probe_row(const T& t, const S* x, S* g) {
  S xr[D], gr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xr[d] = x[d];
  const S lp = value_and_grad<T, D>(t, xr, gr);
#pragma unroll
  for (int d = 0; d < D; ++d) g[d] = gr[d];
  return lp;
}

// A user coordinate functor for the separable kernel (Kernel 7), the
// counterpart of a Target's sep_form (mini_mcmc_tpu/models/base.py:
// 127-149, ops/pallas/hmc_bigd.py:134-167). Target.cuda_coord_source, or
// the C++ user_density.py:derive_coord_dc generates from the target's
// tile_logp, defines one functor named `Coord`:
//
//   struct Coord {
//     static constexpr int kTables;           // 0, 1 or 2
//     explicit Coord(const float* params);    // Target.cuda_params
//     template <class S>                      // S = float or mm::Dual<1>
//     S logp(S x, const mm::CoordTables<kTables>& t) const;
//     float grad(float x, const mm::CoordTables<kTables>& t) const;  // opt.
//   };
//
// one coordinate's term of the density at x, t its entries of the
// sep_form tables (CoordTables<N> is float[N], one unused entry at N = 0),
// under the same rules as a Density (members __device__ __forceinline__,
// the math of this header, coefficients read with __ldg). Without grad
// the derivative is the tangent of logp on Dual<1>.
template <int N>
using CoordTables = float[N > 0 ? N : 1];

template <class F, class = void>
struct has_coord_grad : std::false_type {};
template <class F>
struct has_coord_grad<
    F, std::void_t<decltype(std::declval<const F&>().grad(
           std::declval<float>(),
           std::declval<const CoordTables<F::kTables>&>()))>>
    : std::true_type {};

// F behind coord_targets.cuh's contract. A Gaussian folds a diagonal
// metric's scale into its precision; a user term cannot, so its State
// carries the coordinate's table entries and the scale s, and logp and
// grad evaluate F(s y) and s F'(s y) (s = 1 without a metric, which the
// compiler folds).
template <class F>
struct UserCoord {
  static constexpr int kTables = F::kTables;
  static_assert(kTables >= 0 && kTables <= 2,
                "a coordinate functor reads at most two tables");
  static constexpr bool kTransformed = false;
  struct State {
    CoordTables<kTables> t;
    float s;
  };
  F f;

  __device__ __forceinline__ explicit UserCoord(const float* p) : f(p) {}
  __device__ __forceinline__ State prepare_scaled(float t0, float t1,
                                                  float s) const {
    State st;
    st.t[0] = t0;
    if constexpr (kTables > 1) st.t[1] = t1;
    st.s = s;
    return st;
  }
  __device__ __forceinline__ State prepare(float t0, float t1) const {
    return prepare_scaled(t0, t1, 1.0f);
  }
  __device__ __forceinline__ float logp(float y, const State& st) const {
    return f.logp(st.s * y, st.t);
  }
  __device__ __forceinline__ float grad(float y, const State& st) const {
    const float x = st.s * y;
    if constexpr (has_coord_grad<F>::value) {
      return st.s * f.grad(x, st.t);
    } else {
      Dual<1> xd;
      xd.v = x;
      xd.d[0] = 1.0f;
      xd.nz = 1u;
      const Dual<1> r = f.logp(xd, st.t);
      return st.s * (r.has(0) ? r.d[0] : 0.0f);
    }
  }
};

}  // namespace mm
