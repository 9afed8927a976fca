"""Gibbs conditionals: a 2-component Gaussian mixture with a latent
indicator (counterpart of ``mini_mcmc_tpu/models/mixture.py``; reference
``MixtureConditional``, ``gibbs.rs:235-286``). The state is ``[x, z]``,
z in {0, 1} selecting the component.

``gaussian_mixture_conditional`` names the ``gaussian_mixture`` CUDA
functor (``csrc/conditionals.cuh``). Its coefficients are computed here
once, in double precision as the JAX package computes its Python-float
constants, and reach the kernel as float32: ``mu0, sigma0, mu1, sigma1,
pi0``, then ``1 - pi0``, the two densities' ``1 / sqrt(2 pi var)`` and
their ``2 var``.
"""

from __future__ import annotations

import math

import torch

from .base import Conditional


def mixture_coordinate(params, index: int, states, normal, u):
    """Coordinate ``index`` of every chain under
    ``gaussian_mixture_conditional``, from a standard ``normal`` (x) or a
    uniform ``u`` (z), in the JAX package's operation order
    (``mini_mcmc_tpu/models/mixture.py:26-65``): shared by ``sample`` and
    the Gibbs kernel's plain twin."""
    mu0, sigma0, mu1, sigma1, pi0, pi1, coeff0, coeff1, two_var0, two_var1 = (
        params)
    if index == 0:
        z = states[..., 1]
        mu = torch.where(z < 0.5, mu0, mu1)
        sigma = torch.where(z < 0.5, sigma0, sigma1)
        return mu + sigma * normal
    x = states[..., 0]
    p0 = pi0 * (coeff0 * torch.exp(-((x - mu0) ** 2) / two_var0))
    p1 = pi1 * (coeff1 * torch.exp(-((x - mu1) ** 2) / two_var1))
    total = p0 + p1
    prob_z1 = torch.where(total > 0.0, p1 / total, 0.5)
    return torch.where(u < prob_z1, 1.0, 0.0).to(states.dtype)


def gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1,
                                 pi0) -> Conditional:
    """Full conditionals of the latent-indicator mixture: ``x | z`` is
    N(mu_z, sigma_z^2); ``z | x`` is Bernoulli with p(z=1 | x)
    proportional to ``(1 - pi0) N(x; mu1, sigma1)``."""
    mu0, sigma0, mu1, sigma1, pi0 = (float(v) for v in
                                     (mu0, sigma0, mu1, sigma1, pi0))
    var0, var1 = sigma0 * sigma0, sigma1 * sigma1
    params = (mu0, sigma0, mu1, sigma1, pi0, 1.0 - pi0,
              1.0 / math.sqrt(2.0 * math.pi * var0),
              1.0 / math.sqrt(2.0 * math.pi * var1), 2.0 * var0, 2.0 * var1)

    def sample(gen, index, states):
        shape = states.shape[:-1]
        if index == 0:
            normal = torch.randn(shape, generator=gen, dtype=states.dtype,
                                 device=states.device)
            return mixture_coordinate(params, 0, states, normal, None)
        u = torch.rand(shape, generator=gen, dtype=states.dtype,
                       device=states.device)
        return mixture_coordinate(params, index, states, None, u)

    return Conditional(sample=sample, cuda_functor="gaussian_mixture",
                       cuda_params=params)


def constant_conditional(value) -> Conditional:
    """Test fixture: every coordinate resamples to ``value``
    (``gibbs.rs:217-226``); plain PyTorch only."""

    def sample(gen, index, states):
        del gen, index
        return torch.full(states.shape[:-1], value, dtype=states.dtype,
                          device=states.device)

    return Conditional(sample=sample)
