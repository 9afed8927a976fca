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
// mm::fmin, mm::fmax, mm::logaddexp), which take a float or a Dual alike, and reads its
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
// The same source compiles for the host under host_shim.h, which the CPU
// tests alone use.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "targets.cuh"

namespace mm {

// A value and its N tangents, with the mask of the tangents that may be
// nonzero: an operation touches only those its operands carry. Without
// -use_fast_math the compiler may not fold 0 * x or 0 + x (IEEE signs and
// NaNs), so zero tangents would each cost their arithmetic; the masks are
// integers, which it folds: seeded with the unit vectors and unrolled, a
// density's masks are compile-time constants and every test on them goes.
// A tangent outside the mask holds 0.
template <int N>
struct Dual {
  static_assert(N >= 1 && N <= 32, "a 32-bit mask of tangents");
  float v;
  float d[N];
  uint32_t nz;

  __device__ __forceinline__ Dual() : v(0.0f), nz(0u) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }
  // a constant: no tangents (so `S acc = 0.0f;` holds for either type)
  __device__ __forceinline__ Dual(float c) : v(c), nz(0u) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }

  __device__ __forceinline__ bool has(int i) const {
    return (nz >> i) & 1u;
  }
};

// f(a) with f'(a) = `slope`: the chain rule of every unary function
template <int N>
__device__ __forceinline__ Dual<N> chain(const Dual<N>& a, float value,
                                         float slope) {
  Dual<N> r;
  r.v = value;
  r.nz = a.nz;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (a.has(i)) r.d[i] = a.d[i] * slope;
  }
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  return chain(a, -a.v, -1.0f);
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
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

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
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

template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
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

template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  r.nz = a.nz | b.nz;
  const float inv = 1.0f / b.v;
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

// mixed with a float constant
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  return chain(b, a - b.v, -1.0f);
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  return chain(a, a.v * b, b);
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  return chain(b, a * b.v, a);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  return chain(a, a.v / b, 1.0f / b);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  const float v = a / b.v;
  return chain(b, v, -v / b.v);
}

template <int N, class B>
__device__ __forceinline__ Dual<N>& operator+=(Dual<N>& a, const B& b) {
  return a = a + b;
}
template <int N, class B>
__device__ __forceinline__ Dual<N>& operator-=(Dual<N>& a, const B& b) {
  return a = a - b;
}
template <int N, class B>
__device__ __forceinline__ Dual<N>& operator*=(Dual<N>& a, const B& b) {
  return a = a * b;
}
template <int N, class B>
__device__ __forceinline__ Dual<N>& operator/=(Dual<N>& a, const B& b) {
  return a = a / b;
}

// The functions of a density, on a float and on a Dual. Full-precision
// libm (the library is built without -use_fast_math, _build.NVCC_FLAGS).
__device__ __forceinline__ float value(float a) { return a; }
template <int N>
__device__ __forceinline__ float value(const Dual<N>& a) {
  return a.v;
}

__device__ __forceinline__ float exp(float a) { return expf(a); }
template <int N>
__device__ __forceinline__ Dual<N> exp(const Dual<N>& a) {
  const float e = expf(a.v);
  return chain(a, e, e);
}

__device__ __forceinline__ float log(float a) { return logf(a); }
template <int N>
__device__ __forceinline__ Dual<N> log(const Dual<N>& a) {
  return chain(a, logf(a.v), 1.0f / a.v);
}

__device__ __forceinline__ float log1p(float a) { return log1pf(a); }
template <int N>
__device__ __forceinline__ Dual<N> log1p(const Dual<N>& a) {
  return chain(a, log1pf(a.v), 1.0f / (1.0f + a.v));
}

__device__ __forceinline__ float expm1(float a) { return expm1f(a); }
template <int N>
__device__ __forceinline__ Dual<N> expm1(const Dual<N>& a) {
  return chain(a, expm1f(a.v), expf(a.v));
}

__device__ __forceinline__ float sqrt(float a) { return sqrtf(a); }
template <int N>
__device__ __forceinline__ Dual<N> sqrt(const Dual<N>& a) {
  const float r = sqrtf(a.v);
  return chain(a, r, 0.5f / r);
}

// a^p for a float exponent; d/da = p a^(p - 1)
__device__ __forceinline__ float pow(float a, float p) { return powf(a, p); }
template <int N>
__device__ __forceinline__ Dual<N> pow(const Dual<N>& a, float p) {
  return chain(a, powf(a.v, p), p * powf(a.v, p - 1.0f));
}

__device__ __forceinline__ float tanh(float a) { return tanhf(a); }
template <int N>
__device__ __forceinline__ Dual<N> tanh(const Dual<N>& a) {
  const float t = tanhf(a.v);
  return chain(a, t, (1.0f - t) * (1.0f + t));
}

__device__ __forceinline__ float sin(float a) { return sinf(a); }
template <int N>
__device__ __forceinline__ Dual<N> sin(const Dual<N>& a) {
  return chain(a, sinf(a.v), cosf(a.v));
}

__device__ __forceinline__ float cos(float a) { return cosf(a); }
template <int N>
__device__ __forceinline__ Dual<N> cos(const Dual<N>& a) {
  return chain(a, cosf(a.v), -sinf(a.v));
}

// |a|, slope sign(a) (0 at 0, as torch.abs's)
__device__ __forceinline__ float abs(float a) { return fabsf(a); }
template <int N>
__device__ __forceinline__ Dual<N> abs(const Dual<N>& a) {
  return chain(a, fabsf(a.v), a.v > 0.0f ? 1.0f : a.v < 0.0f ? -1.0f : 0.0f);
}

// the smaller (larger) operand with its tangents; a tie takes the first
__device__ __forceinline__ float fmin(float a, float b) {
  return fminf(a, b);
}
template <int N>
__device__ __forceinline__ Dual<N> fmin(const Dual<N>& a, const Dual<N>& b) {
  return b.v < a.v ? b : a;
}
template <int N>
__device__ __forceinline__ Dual<N> fmin(const Dual<N>& a, float b) {
  return b < a.v ? Dual<N>(b) : a;
}
template <int N>
__device__ __forceinline__ Dual<N> fmin(float a, const Dual<N>& b) {
  return b.v < a ? b : Dual<N>(a);
}
__device__ __forceinline__ float fmax(float a, float b) {
  return fmaxf(a, b);
}
template <int N>
__device__ __forceinline__ Dual<N> fmax(const Dual<N>& a, const Dual<N>& b) {
  return b.v > a.v ? b : a;
}
template <int N>
__device__ __forceinline__ Dual<N> fmax(const Dual<N>& a, float b) {
  return b > a.v ? Dual<N>(b) : a;
}
template <int N>
__device__ __forceinline__ Dual<N> fmax(float a, const Dual<N>& b) {
  return b.v > a ? b : Dual<N>(a);
}

// log(exp(a) + exp(b)) as torch.logaddexp computes it: an infinite a
// equal to b gives a (so two -inf give -inf), else max + log1p(exp(-|a -
// b|)); d/da = exp(a - r), 1/2 each where both are the same infinity
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(expf(-fabsf(a - b)));
}
template <int N>
__device__ __forceinline__ Dual<N> logaddexp(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = logaddexp(a.v, b.v);
  r.nz = a.nz | b.nz;
  const bool tie = isinf(a.v) && a.v == b.v;
  const float wa = tie ? 0.5f : expf(a.v - r.v);
  const float wb = tie ? 0.5f : expf(b.v - r.v);
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
template <int N>
__device__ __forceinline__ Dual<N> logaddexp(const Dual<N>& a, float b) {
  return logaddexp(a, Dual<N>(b));
}
template <int N>
__device__ __forceinline__ Dual<N> logaddexp(float a, const Dual<N>& b) {
  return logaddexp(Dual<N>(a), b);
}

// Whether F defines grad<D>(const float (&)[D], float (&)[D]).
template <class F, int D, class = void>
struct has_grad : std::false_type {};
template <class F, int D>
struct has_grad<F, D,
                std::void_t<decltype(std::declval<const F&>()
                                         .template grad<D>(
                                             std::declval<const float (&)[D]>(),
                                             std::declval<float (&)[D]>()))>>
    : std::true_type {};

// A user functor F behind the contract of targets.cuh.
template <class F>
struct User {
  F f;

  __device__ __forceinline__ explicit User(const float* p) : f(p) {}

  template <int D>
  __device__ __forceinline__ float logp(const float (&x)[D]) const {
    return f.template logp<float, D>(x);
  }

  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
    if constexpr (has_grad<F, D>::value) {
      f.template grad<D>(x, g);
    } else {
      dual_pass(x, g);
    }
  }

  // without a source gradient, the dual pass's value is the logp: the
  // leaves of Kernels 3 and 4 take both from it (targets.cuh:
  // value_and_grad)
  template <int D, std::enable_if_t<!has_grad<F, D>::value, int> = 0>
  __device__ __forceinline__ float logp_and_grad(const float (&x)[D],
                                                 float (&g)[D]) const {
    return dual_pass(x, g);
  }

 private:
  template <int D>
  __device__ __forceinline__ float dual_pass(const float (&x)[D],
                                             float (&g)[D]) const {
    Dual<D> xd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      xd[i].v = x[i];
      xd[i].d[i] = 1.0f;
      xd[i].nz = 1u << i;
    }
    const Dual<D> r = f.template logp<Dual<D>, D>(xd);
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = r.has(i) ? r.d[i] : 0.0f;
    return r.v;
  }
};

// One chain of the validation probe: the instance's logp and gradient at
// x (the entries mm_user_probe of a per-density library, and of its host
// build for the tests).
template <class T, int D>
__device__ __forceinline__ float probe_row(const T& t, const float* x,
                                           float* g) {
  float xr[D], gr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xr[d] = x[d];
  const float lp = value_and_grad<T, D>(t, xr, gr);
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
