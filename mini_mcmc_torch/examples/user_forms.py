"""User forms for the fused kernels: C++ sources with their PyTorch twins.

The kernels run a density, proposal, conditional or coordinate term that
names no built-in functor as the user's own C++, under the contracts of
``csrc/user_density.cuh`` (``Density``, ``Coord``), ``csrc/proposals.cuh``
(``Proposal``) and ``csrc/conditionals.cuh`` (``Conditional``); a
proposal's and a conditional's PyTorch twin draws from the same Philox
words (``propose_words``, ``sample_words``), the counterpart of the JAX
package's one ``propose_dc`` and ``sample_dc``
(``mini_mcmc_tpu/models/base.py:446-494``). The forms here are the ones
the tests and ``chip_smoke.py`` run:

- :func:`gaussian2d_user`: the Gaussian2D of ``models/gaussian.py`` as a
  ``cuda_source`` that copies ``targets.cuh:Gaussian2D``'s arithmetic, so
  the MH kernel gives the built-in instance's cube bit for bit; or, with
  ``hand=False``, the plain batch form the kernels trace.
- :func:`bimodal`: bench.py's tempering density (``bench.py:863-876``),
  ``logaddexp`` of two Gaussian modes, as a batch form (traced) or with a
  ``cuda_source``.
- :func:`rosenbrock_banana`: ``examples/rosenbrock_mh.py``'s density, a
  plain batch form.
- :func:`isotropic_walk`: ``isotropic_gaussian_proposal``'s walk
  (``models/gaussian.py``; the JAX ``propose_dc``, ``gaussian.py:162-167``)
  as a user proposal, arithmetic for arithmetic;
  :func:`scaled_walk` a walk with its own scale per coordinate.
- :func:`mixture_conditional`: ``gaussian_mixture_conditional``'s
  conditionals as a user source, copying ``conditionals.cuh``.
- :func:`logistic`: independent logistic coordinates with scales ``s_d``,
  ``-|x|/s - 2 log1p(exp(-|x|/s)) - log s`` (variance ``pi^2 s^2 / 3``),
  one table, as a ``cuda_coord_source`` with its own ``grad`` or, with
  ``hand=False``, generated from the tile form.
- :func:`rosenbrock_user`: ``models.rosenbrock.rosenbrock_nd`` at any D
  as a ``cuda_source`` without a gradient (the kernels take it from dual
  numbers), written with integer literals so that its float64 instance
  (Kernel 1 on float64 states) is exact; or, with ``hand=False``, the
  batch form the kernels trace.
- :func:`poisson_user`: ``models.discrete.poisson_target`` on int32
  states as a ``cuda_source`` that copies ``targets.cuh:Poisson``, so the
  MH kernel gives the built-in instance's cube bit for bit;
  ``models.discrete.binomial_target`` is the traced int32 density (it
  has no functor).
- :func:`int_walk`: ``random_walk_int_proposal``'s +-1 walk as a user
  int32 proposal (``proposals.cuh:RandomWalkInt`` written as a source),
  its twin the built-in's draw.
"""

from __future__ import annotations

import math

import torch

from ..models.base import Conditional, Proposal, Target
from ..models.discrete import poisson_target, random_walk_int_proposal
from ..models.gaussian import gaussian2d, isotropic_gaussian_proposal
from ..models.rosenbrock import rosenbrock_nd
from ..models.mixture import gaussian_mixture_conditional
from ..ops.kernels import rng
from ..ops.kernels.gibbs_full import SAMPLE_FROM_WORDS
from ..ops.kernels.mh_full import PROPOSE_FROM_WORDS

GAUSSIAN2D_SOURCE = """
// targets.cuh:Gaussian2D, term for term
struct Density {
  float m0, m1, ic00, ic01, ic10, ic11, ic_cross, nc;

  __device__ __forceinline__ explicit Density(const float* p)
      : m0(__ldg(p + 0)), m1(__ldg(p + 1)), ic00(__ldg(p + 2)),
        ic01(__ldg(p + 3)), ic10(__ldg(p + 4)), ic11(__ldg(p + 5)),
        ic_cross(ic01 + ic10), nc(__ldg(p + 6)) {}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    static_assert(D == 2, "Gaussian2D is two-dimensional");
    const S d0 = x[0] - m0, d1 = x[1] - m1;
    const S quad = ic00 * d0 * d0 + ic_cross * d0 * d1 + ic11 * d1 * d1;
    return nc - 0.5f * quad;
  }
};
"""

BIMODAL_SOURCE = """
// log(w0 N(x0; -8, 0.5^2) + w1 N(x0; 8, 0.5^2)) up to a constant;
// params: log w0, log w1
struct Density {
  float lw0, lw1;

  __device__ __forceinline__ explicit Density(const float* p)
      : lw0(__ldg(p)), lw1(__ldg(p + 1)) {}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    const S u = (x[0] + 8.0f) / 0.5f;
    const S v = (x[0] - 8.0f) / 0.5f;
    return mm::logaddexp(lw0 - (u * u) * 0.5f, lw1 - (v * v) * 0.5f);
  }
};
"""

ISOTROPIC_WALK_SOURCE = """
// proposals.cuh:IsotropicGaussian: x + std N(0, 1), normals 2p and 2p + 1
// the cosine and sine of box_muller_pair(w[2p], w[2p + 1]); params: std
struct Proposal {
  float std;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 2 * ((D + 1) / 2);
  }

  __device__ __forceinline__ explicit Proposal(const float* p)
      : std(__ldg(p)) {}

  template <int D>
  __device__ __forceinline__ void propose(const float (&x)[D],
                                          const uint32_t* w,
                                          float (&y)[D]) const {
#pragma unroll
    for (int p = 0; 2 * p < D; ++p) {
      float c, s;
      mm::box_muller_pair(w[2 * p], w[2 * p + 1], c, s);
      y[2 * p] = x[2 * p] + __fmul_rn(std, c);
      if (2 * p + 1 < D) y[2 * p + 1] = x[2 * p + 1] + __fmul_rn(std, s);
    }
  }
};
"""

ROSENBROCK_SOURCE = """
// models/rosenbrock.py:rosenbrock_nd at any D: -sum_i [100 (x_{i+1} -
// x_i^2)^2 + (1 - x_i)^2], its gradient from dual numbers; integer
// literals convert exactly to float or double
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S s = 0;
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const S d = x[i + 1] - x[i] * x[i];
      s = s + 100 * (d * d) + (1 - x[i]) * (1 - x[i]);
    }
    return -s;
  }
};
"""

POISSON_SOURCE = """
// targets.cuh:Poisson, term for term, on int32 states: (k ln(lam) - lam)
// - lgamma(k + 1), -inf for k < 0, lgammaf(k + 1) read from a block table
// for k < 64 (the constructor synchronises the block); params: log_lam,
// lam
struct Density {
  static constexpr int kTable = 64;
  float log_lam, lam;
  const float* table;

  __device__ __forceinline__ explicit Density(const float* p)
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
    const float lg = k[0] < kTable ? table[k[0]] : mm::lgamma(kf + 1.0f);
    return (__fmul_rn(kf, log_lam) - lam) - lg;
  }
};
"""

INT_WALK_SOURCE = """
// proposals.cuh:RandomWalkInt on int32 states: x +- 1 by the top bit of
// word d (clear: +1), reflected at lo and, when has_hi, at hi; params: lo,
// hi, has_hi
struct Proposal {
  int32_t lo, hi;
  bool has_hi;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return D;
  }

  __device__ __forceinline__ explicit Proposal(const float* p)
      : lo((int32_t)__ldg(p + 0)), hi((int32_t)__ldg(p + 1)),
        has_hi(__ldg(p + 2) != 0.0f) {}

  template <int D>
  __device__ __forceinline__ void propose(const int32_t (&x)[D],
                                          const uint32_t* w,
                                          int32_t (&y)[D]) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      int32_t v = max(x[d] + ((w[d] >> 31) == 0u ? 1 : -1), lo);
      if (has_hi) v = min(v, hi);
      y[d] = v;
    }
  }
};
"""

SCALED_WALK_SOURCE = """
// x_d + s_d N(0, 1), the normals of the isotropic walk; params: s_0..s_D-1
struct Proposal {
  const float* s_;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 2 * ((D + 1) / 2);
  }

  __device__ __forceinline__ explicit Proposal(const float* p) : s_(p) {}

  template <int D>
  __device__ __forceinline__ void propose(const float (&x)[D],
                                          const uint32_t* w,
                                          float (&y)[D]) const {
#pragma unroll
    for (int p = 0; 2 * p < D; ++p) {
      float c, s;
      mm::box_muller_pair(w[2 * p], w[2 * p + 1], c, s);
      y[2 * p] = x[2 * p] + __fmul_rn(__ldg(s_ + 2 * p), c);
      if (2 * p + 1 < D) {
        y[2 * p + 1] = x[2 * p + 1] + __fmul_rn(__ldg(s_ + 2 * p + 1), s);
      }
    }
  }
};
"""

MIXTURE_CONDITIONAL_SOURCE = """
// conditionals.cuh:GaussianMixture over [x, z], term for term; params as
// models/mixture.py:gaussian_mixture_conditional's
struct Conditional {
  float mu0, sigma0, mu1, sigma1, pi0, pi1, coeff0, coeff1, two_var0,
      two_var1;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 3;
  }

  __device__ __forceinline__ explicit Conditional(const float* p)
      : mu0(__ldg(p + 0)), sigma0(__ldg(p + 1)), mu1(__ldg(p + 2)),
        sigma1(__ldg(p + 3)), pi0(__ldg(p + 4)), pi1(__ldg(p + 5)),
        coeff0(__ldg(p + 6)), coeff1(__ldg(p + 7)), two_var0(__ldg(p + 8)),
        two_var1(__ldg(p + 9)) {}

  template <int D>
  __device__ __forceinline__ float sample(int i, const float (&s)[D],
                                          const uint32_t* w) const {
    static_assert(D == 2, "the mixture's state is [x, z]");
    if (i == 0) {
      const bool low = s[1] < 0.5f;
      const float mu = low ? mu0 : mu1;
      const float sigma = low ? sigma0 : sigma1;
      return mu + __fmul_rn(sigma, mm::box_muller(w[0], w[1]));
    }
    const float d0 = s[0] - mu0, d1 = s[0] - mu1;
    const float p0 =
        __fmul_rn(pi0, coeff0 * expf(-__fmul_rn(d0, d0) / two_var0));
    const float p1 =
        __fmul_rn(pi1, coeff1 * expf(-__fmul_rn(d1, d1) / two_var1));
    const float total = p0 + p1;
    const float prob_z1 = total > 0.0f ? p1 / total : 0.5f;
    return mm::unit_open(w[2]) < prob_z1 ? 1.0f : 0.0f;
  }
};
"""

LOGISTIC_COORD_SOURCE = """
// one logistic coordinate of scale s = t[0]: z = |x| / s,
// -z - 2 log1p(exp(-z)) - log s, derivative -tanh(x / 2s) / s
struct Coord {
  static constexpr int kTables = 1;

  __device__ __forceinline__ explicit Coord(const float*) {}

  template <class S>
  __device__ __forceinline__ S logp(S x,
                                    const mm::CoordTables<kTables>& t) const {
    const S z = mm::abs(x) / t[0];
    return -z - 2.0f * mm::log1p(mm::exp(-z)) - mm::log(t[0]);
  }

  __device__ __forceinline__ float grad(
      float x, const mm::CoordTables<kTables>& t) const {
    return -mm::tanh(0.5f * x / t[0]) / t[0];
  }
};
"""


def gaussian2d_user(mean, cov, hand: bool = True) -> Target:
    """``models.gaussian.gaussian2d`` without its functor: the kernels run
    :data:`GAUSSIAN2D_SOURCE` on the same seven params (``hand``), or the
    C++ they generate from the batch form."""
    g = gaussian2d(mean, cov)
    if not hand:
        return Target(logp=g.logp, logp_normalized=g.logp_normalized)
    return Target(logp=g.logp, logp_normalized=g.logp_normalized,
                  cuda_source=GAUSSIAN2D_SOURCE, cuda_params=g.cuda_params)


def rosenbrock_user(hand: bool = True) -> Target:
    """``models.rosenbrock.rosenbrock_nd()`` without its functor: the
    kernels run :data:`ROSENBROCK_SOURCE` (``hand``) or the C++ they
    generate from the batch form."""
    r = rosenbrock_nd()
    if not hand:
        return Target(logp=r.logp)
    return Target(logp=r.logp, cuda_source=ROSENBROCK_SOURCE)


def poisson_user(lam) -> Target:
    """``models.discrete.poisson_target(lam)`` without its functor: the
    MH kernel runs :data:`POISSON_SOURCE` (int32 states) on the same two
    params; the batch form is the built-in's."""
    p = poisson_target(lam)
    return Target(logp=p.logp, cuda_source=POISSON_SOURCE,
                  cuda_params=p.cuda_params)


def int_walk(clip_low=0, clip_high=None) -> Proposal:
    """``random_walk_int_proposal(clip_low, clip_high)`` as a user int32
    proposal: :data:`INT_WALK_SOURCE` on the built-in's params, its twin
    the built-in's draw (``mh_full.py``'s), so that both the kernel's and
    the twin's cubes equal the built-in's."""
    walk = random_walk_int_proposal(clip_low, clip_high)
    words_of, propose_words = PROPOSE_FROM_WORDS["random_walk_int"]
    return Proposal(sample=walk.sample, logp=walk.logp, symmetric=True,
                    cuda_source=INT_WALK_SOURCE,
                    cuda_params=walk.cuda_params,
                    propose_words=propose_words, cuda_words=words_of)


def bimodal(w_plus: float = 0.7, hand: bool = False) -> Target:
    """bench.py's tempering target, ``(1 - w_plus) N(-8, 0.5^2) + w_plus
    N(8, 0.5^2)`` on coordinate 0, written with ``torch.logaddexp``; with
    ``hand`` it carries :data:`BIMODAL_SOURCE`."""
    lw0, lw1 = math.log(1.0 - w_plus), math.log(w_plus)

    def logp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    if not hand:
        return Target(logp=logp)
    return Target(logp=logp, cuda_source=BIMODAL_SOURCE,
                  cuda_params=(lw0, lw1))


def rosenbrock_banana() -> Target:
    """``examples/rosenbrock_mh.py``'s density, ``-((1 - x)^2 + 100 (y -
    x^2)^2) / 20``, a plain batch form."""

    def logp(pos):
        x, y = pos[..., 0], pos[..., 1]
        return -((1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2) / 20.0

    return Target(logp=logp)


def _pair_words(d: int) -> int:
    return 2 * ((d + 1) // 2)


def isotropic_walk(std) -> Proposal:
    """``isotropic_gaussian_proposal(std)`` as a user proposal:
    :data:`ISOTROPIC_WALK_SOURCE` and its twin, the built-in's own draw
    (``mh_full.py``'s), so that both the kernel's and the twin's cubes
    equal the built-in's."""
    std = float(std)
    walk = isotropic_gaussian_proposal(std)

    def propose_words(params, current, words):
        return current + params[0] * rng.pair_normals(words,
                                                      current.shape[1])

    return Proposal(sample=walk.sample, logp=walk.logp, symmetric=True,
                    scaled=lambda f: isotropic_walk(std * f),
                    cuda_source=ISOTROPIC_WALK_SOURCE, cuda_params=(std,),
                    propose_words=propose_words, cuda_words=_pair_words)


def scaled_walk(scales) -> Proposal:
    """A Gaussian walk with scale ``scales[d]`` on coordinate d, as a user
    proposal (:data:`SCALED_WALK_SOURCE`) with its twin."""
    scales = tuple(float(s) for s in scales)

    def sample(gen, current):
        s = torch.tensor(scales, dtype=current.dtype, device=current.device)
        return current + s * torch.randn(current.shape, generator=gen,
                                         dtype=current.dtype,
                                         device=current.device)

    def logp(frm, to):
        s = torch.tensor(scales, dtype=frm.dtype, device=frm.device)
        z = (to - frm) / s
        return (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(s))
                - 0.5 * len(scales) * math.log(2.0 * math.pi))

    def propose_words(params, current, words):
        s = torch.tensor(params, dtype=current.dtype, device=current.device)
        return current + s * rng.pair_normals(words, current.shape[1])

    return Proposal(sample=sample, logp=logp, symmetric=True,
                    scaled=lambda f: scaled_walk([s * f for s in scales]),
                    cuda_source=SCALED_WALK_SOURCE, cuda_params=scales,
                    propose_words=propose_words, cuda_words=_pair_words)


def mixture_conditional(mu0, sigma0, mu1, sigma1, pi0) -> Conditional:
    """``gaussian_mixture_conditional`` as a user conditional:
    :data:`MIXTURE_CONDITIONAL_SOURCE` on the built-in's params, its twin
    the built-in's draw (``gibbs_full.py``'s)."""
    built_in = gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0)
    words_of, sample_words = SAMPLE_FROM_WORDS["gaussian_mixture"]
    return Conditional(sample=built_in.sample,
                       cuda_source=MIXTURE_CONDITIONAL_SOURCE,
                       cuda_params=built_in.cuda_params,
                       sample_words=sample_words, cuda_words=words_of)


def logistic(scales, hand: bool = True) -> Target:
    """Independent logistic coordinates of scales ``s_d`` (variance
    ``pi^2 s_d^2 / 3``), a ``sep_form`` of one table; with ``hand`` the
    separable kernel runs :data:`LOGISTIC_COORD_SOURCE` (its own
    gradient), else the functor generated from the tile form."""
    scales = torch.as_tensor(scales, dtype=torch.float32)

    def tile(x, s):
        z = (x / s).abs()
        return torch.sum(-z - 2.0 * torch.log1p(torch.exp(-z))
                         - torch.log(s), dim=-1)

    def logp(x):
        return tile(x, scales.to(x.device, x.dtype))

    return Target(logp=logp, sep_form=(tile, (scales,)),
                  cuda_coord_source=LOGISTIC_COORD_SOURCE if hand else None)
