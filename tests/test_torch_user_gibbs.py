"""User conditionals in the Gibbs kernel (Kernel 6):
``Conditional.cuda_source`` with its twin ``sample_words``, built for the
host with ``g++`` through ``csrc/host_shim.h`` (the text nvcc compiles),
against the twin, the built-in functor it copies and the JAX package's
XLA tier.

Tolerances: a compiled sweep against its PyTorch twin within 8 float32
ulps (glibc's ``expf``/``logf``/``cosf`` on the host against PyTorch's
vectorised CPU kernels, an ulp or two each; the mixture's indicator equal
on every row); the source that copies ``GaussianMixture`` against the
built-in functor's host build bit for bit; the twins' cubes bit for bit;
the moments within 5 standard errors of the truth (indicator frequency
within 0.02) for both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import mini_mcmc_tpu as jmt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import Conditional
from mini_mcmc_torch.models.base import validate_conditional_dc
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_torch.ops.kernels.gibbs_full import (
    gibbs_instance,
    gibbs_multistep_plain,
    sample_form,
)
from mini_mcmc_tpu import models as jm

MIX = (-2.0, 1.0, 3.0, 1.5, 0.5)
RHO = 0.5  # the equicorrelated Gaussian at D = 3

# x_i | x_-i of the unit-variance equicorrelated Gaussian at D = 3, rho =
# 0.5: N(sum_{j != i} x_j / 3, 2 / 3); coordinate i's normal the cosine of
# box_muller(w[2i], w[2i + 1]). params: the mean's coefficient, the sd
EQUI_SOURCE = """
struct Conditional {
  float coef, sd;

  template <int D>
  __host__ __device__ static constexpr int words() {
    return 2 * D;
  }

  __device__ __forceinline__ explicit Conditional(const float* p)
      : coef(__ldg(p)), sd(__ldg(p + 1)) {}

  template <int D>
  __device__ __forceinline__ float sample(int i, const float (&s)[D],
                                          const uint32_t* w) const {
    float others = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j != i) others += s[j];
    }
    return __fmul_rn(coef, others) +
           __fmul_rn(sd, mm::box_muller(w[2 * i], w[2 * i + 1]));
  }
};
"""
EQUI_PARAMS = (1.0 / 3.0, float(np.sqrt(2.0 / 3.0)))


def _equi_words(params, i, states, words):
    others = torch.zeros_like(states[:, 0])
    for j in range(states.shape[1]):
        if j != i:
            others = others + states[:, j]
    return (params[0] * others
            + params[1] * rng.box_muller(words[:, 2 * i], words[:, 2 * i + 1]))


def _equi() -> Conditional:
    def sample(gen, index, states):
        n = torch.randn(states.shape[:-1], generator=gen, dtype=states.dtype)
        others = states.sum(-1) - states[..., index]
        return EQUI_PARAMS[0] * others + EQUI_PARAMS[1] * n

    return Conditional(sample=sample, cuda_source=EQUI_SOURCE,
                       cuda_params=EQUI_PARAMS, sample_words=_equi_words,
                       cuda_words=lambda d: 2 * d)


def _sweep(cond, x, words):
    out = x.clone()
    for i in range(x.shape[1]):
        out[:, i] = cond.sample_words(cond.cuda_params, i, out, words)
    return out


def _states(c, seed):
    g = np.random.default_rng(seed)
    x = (3.0 * g.standard_normal(c)).astype(np.float32)
    z = (g.random(c) < 0.5).astype(np.float32)
    return torch.from_numpy(np.stack([x, z], axis=1))


def _within_ulps(got, want, n=8):
    ulp = torch.finfo(torch.float32).eps * want.abs().clamp(min=1.0)
    return bool(((got - want).abs() <= n * ulp).all())


def test_mixture_source_against_its_twin_and_the_builtin():
    x = _states(512, 3)
    cond = F.mixture_conditional(*MIX)
    words = rng.stream_words(512, 3, 9, 0x5EED_6161)
    got = U.sample_probe(cond, x, words)
    want = _sweep(cond, x, words)
    assert _within_ulps(got[:, 0], want[:, 0])
    assert torch.equal(got[:, 1], want[:, 1])
    copy = Conditional(
        sample=cond.sample,
        cuda_source=("struct Conditional : mm::GaussianMixture {\n"
                     "  using mm::GaussianMixture::GaussianMixture;\n};\n"),
        cuda_params=cond.cuda_params, sample_words=cond.sample_words,
        cuda_words=cond.cuda_words)
    assert torch.equal(got, U.sample_probe(copy, x, words))
    validate_conditional_dc(cond, x)


def test_a_copied_conditional_gives_the_builtin_twins_cube():
    x = _states(256, 4)
    cubes = []
    for cond in (mt.gaussian_mixture_conditional(*MIX),
                 F.mixture_conditional(*MIX)):
        hist = torch.empty((16, 256, 2))
        gibbs_multistep_plain(cond, x, 0x5EED_6262, 3, 16, hist)
        cubes.append(hist)
    assert torch.equal(cubes[0], cubes[1])
    a, b = (mt.GibbsSampler(c, x, use_pallas="full", steps_per_call=8,
                            device="cpu").seed(4).run(32)
            for c in (mt.gaussian_mixture_conditional(*MIX),
                      F.mixture_conditional(*MIX)))
    assert torch.equal(a, b)


def test_a_d3_user_conditional_against_its_twin():
    g = np.random.default_rng(6)
    x = torch.from_numpy(g.standard_normal((256, 3)).astype(np.float32))
    cond = _equi()
    words = rng.stream_words(256, 6, 2, 0x5EED_6363)
    got = U.sample_probe(cond, x, words)
    assert _within_ulps(got, _sweep(cond, x, words))
    validate_conditional_dc(cond, x)


def test_gibbs_with_user_conditionals_passes_the_gates_of_the_jax_xla_path():
    """The port's fused tier's twin on the user mixture and the D = 3
    equicorrelated conditional, the JAX package's XLA tier on the built-in
    mixture: the same gates."""
    mu0, sigma0, mu1, sigma1, pi0 = MIX
    mean = pi0 * mu0 + (1 - pi0) * mu1
    var = (pi0 * (sigma0 ** 2 + (mu0 - mean) ** 2)
           + (1 - pi0) * (sigma1 ** 2 + (mu1 - mean) ** 2))
    x0 = np.zeros((1024, 2), np.float32)
    port = mt.GibbsSampler(F.mixture_conditional(*MIX), torch.from_numpy(x0),
                           use_pallas="full", steps_per_call=16,
                           device="cpu").seed(3)
    jg = jmt.GibbsSampler(jm.gaussian_mixture_conditional(*MIX),
                          jnp.asarray(x0)).seed(3)
    for what, s in (("port", port.run(256, 64)),
                    ("jax", torch.from_numpy(np.array(jg.run(256, 64))))):
        xs = s[..., 0].double()
        n_eff = xs.numel() / 20.0  # the indicator's flips mix slowly
        assert abs(float(xs.mean()) - mean) <= 5 * (var / n_eff) ** 0.5, what
        assert abs(float(xs.var()) / var - 1) <= 0.1, what
        assert abs(float(s[..., 1].double().mean()) - (1 - pi0)) <= 0.02, what
    equi = mt.GibbsSampler(_equi(), torch.zeros((1024, 3)),
                           use_pallas="full", steps_per_call=8,
                           device="cpu").seed(1).run(256, 32)
    cov = torch.cov(equi.reshape(-1, 3).T.double())
    want = torch.full((3, 3), RHO, dtype=torch.float64).fill_diagonal_(1.0)
    assert float((cov - want).abs().max()) <= 0.05


def test_refusals_name_the_missing_field():
    cond = F.mixture_conditional(*MIX)
    twin_only = Conditional(sample=cond.sample,
                            sample_words=cond.sample_words,
                            cuda_words=cond.cuda_words)
    assert sample_form(twin_only)[1] is cond.sample_words
    with pytest.raises(ValueError, match="Conditional.cuda_source"):
        gibbs_instance(twin_only, 2)
    with pytest.raises(ValueError, match="sample_words"):
        sample_form(Conditional(sample=cond.sample, cuda_source="x"))
    with pytest.raises(ValueError, match="not both"):
        Conditional(sample=cond.sample, cuda_functor="gaussian_mixture",
                    cuda_source="x")
    assert gibbs_instance(cond, 2) == -1
    with pytest.raises(ValueError, match="D <= 16"):
        gibbs_instance(cond, 17)


def test_validate_dc_catches_a_wrong_twin_and_words():
    x = _states(128, 8)
    cond = F.mixture_conditional(*MIX)

    def off(params, i, states, words):
        v = cond.sample_words(params, i, states, words)
        return v * 1.01 if i == 0 else v

    wrong = Conditional(sample=cond.sample, cuda_source=cond.cuda_source,
                        cuda_params=cond.cuda_params, sample_words=off,
                        cuda_words=cond.cuda_words)
    with pytest.raises(ValueError, match="compiled sweep"):
        validate_conditional_dc(wrong, x)
    words4 = Conditional(sample=cond.sample, cuda_source=cond.cuda_source,
                         cuda_params=cond.cuda_params,
                         sample_words=cond.sample_words,
                         cuda_words=lambda d: 4)
    with pytest.raises(ValueError, match="cuda_words"):
        validate_conditional_dc(words4, x)
