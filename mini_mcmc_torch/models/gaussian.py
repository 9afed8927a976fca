"""Gaussian targets and proposals (counterpart of
``mini_mcmc_tpu/models/gaussian.py``).

``gaussian2d`` and ``diffable_gaussian2d`` evaluate the 2x2 quadratic
scalar-wise with Python-float coefficients, in the operation order of the
JAX package's chains-on-lanes forms (``logp_dc``/``grad_dc``), which the
fused kernels on both sides run. Both name the ``gaussian2d`` CUDA functor
(``csrc/targets.cuh``) and hand it seven coefficients in
``Target.cuda_params``; ``gaussian2d`` passes a normalizing constant of
0.0, and ``0 - 0.5 quad`` rounds as JAX's ``-0.5 quad`` does.
``isotropic_gaussian_proposal`` names the ``isotropic_gaussian`` functor
(``csrc/proposals.cuh``). ``standard_normal`` and
``isotropic_gaussian_target`` name coordinate functors of the separable
HMC tier (``csrc/coord_targets.cuh``, ``_build.SEP_FUNCTORS``), which no
other kernel runs.
"""

from __future__ import annotations

import math

import torch

from .base import Proposal, Target


def _inverse_2x2(mean, cov):
    m0, m1 = (float(v) for v in mean)
    (a, b), (c, d) = ((float(v) for v in row) for row in cov)
    det = a * d - b * c
    return m0, m1, d / det, -b / det, -c / det, a / det, det


def _quad(pos, m0, m1, ic00, ic_cross, ic11):
    d0 = pos[..., 0] - m0
    d1 = pos[..., 1] - m1
    return ic00 * d0 * d0 + ic_cross * d0 * d1 + ic11 * d1 * d1


def gaussian2d(mean, cov) -> Target:
    """2D Gaussian target (reference ``Gaussian2D``,
    ``distributions.rs:158-206``): ``logp`` is the unnormalized
    ``-0.5 (x - m)^T S^-1 (x - m)``, ``logp_normalized`` adds
    ``-ln(2 pi) - 0.5 ln|det S|``."""
    m0, m1, ic00, ic01, ic10, ic11, det = _inverse_2x2(mean, cov)
    ic_cross = ic01 + ic10
    log_norm = -math.log(2.0 * math.pi) - 0.5 * math.log(abs(det))

    def logp(pos):
        return 0.0 - 0.5 * _quad(pos, m0, m1, ic00, ic_cross, ic11)

    def logp_normalized(pos):
        return log_norm - 0.5 * _quad(pos, m0, m1, ic00, ic_cross, ic11)

    return Target(logp=logp, logp_normalized=logp_normalized,
                  cuda_functor="gaussian2d",
                  cuda_params=(m0, m1, ic00, ic01, ic10, ic11, 0.0))


def diffable_gaussian2d(mean, cov) -> Target:
    """Normalized 2D Gaussian for gradient-based samplers
    (``DiffableGaussian2D``, reference ``distributions.rs:212-316``):
    ``logp = norm_const - 0.5 (x - m)^T S^-1 (x - m)``."""
    m0, m1, ic00, ic01, ic10, ic11, det = _inverse_2x2(mean, cov)
    nc = -(2.0 * math.log(2.0 * math.pi) + math.log(det)) / 2.0
    ic_cross = ic01 + ic10

    def logp(pos):
        return nc - 0.5 * _quad(pos, m0, m1, ic00, ic_cross, ic11)

    def grad(pos):
        d0 = pos[..., 0] - m0
        d1 = pos[..., 1] - m1
        g0 = -(ic00 * d0 + ic01 * d1)
        g1 = -(ic10 * d0 + ic11 * d1)
        return torch.stack([g0, g1], dim=-1)

    return Target(logp=logp, grad=grad, cuda_functor="gaussian2d",
                  cuda_params=(m0, m1, ic00, ic01, ic10, ic11, nc),
                  logp_normalized=logp)


def isotropic_gaussian_proposal(std) -> Proposal:
    """Isotropic Gaussian random walk, any dimension (reference
    ``IsotropicGaussian``, ``distributions.rs:362-396``). ``logp`` keeps
    the reference's own normalization ``-d/2 ln(pi std^4)``
    (``distributions.rs:379-386``); it cancels in the accept ratio."""
    std = float(std)

    def sample(gen, current):
        return current + std * torch.randn(
            current.shape, generator=gen, dtype=current.dtype,
            device=current.device)

    def logp(frm, to):
        var = std * std
        diff = to - frm
        lp = -torch.sum(diff * diff, dim=-1) / (2.0 * var)
        d = frm.shape[-1]
        return lp - d * 0.5 * math.log(var * math.pi * std * std)

    return Proposal(sample=sample, logp=logp, symmetric=True,
                    scaled=lambda f: isotropic_gaussian_proposal(std * f),
                    cuda_functor="isotropic_gaussian", cuda_params=(std,),
                    takes_state_split=True)


def gaussian_random_walk_proposal(scales) -> Proposal:
    """Gaussian random walk with per-dimension ``scales``; plain PyTorch
    only (no CUDA form)."""
    scales = torch.as_tensor(scales)

    def sample(gen, current):
        s = scales.to(current.dtype).to(current.device)
        return current + s * torch.randn(
            current.shape, generator=gen, dtype=current.dtype,
            device=current.device)

    def logp(frm, to):
        s = scales.to(frm.dtype).to(frm.device)
        diff = (to - frm) / s
        d = frm.shape[-1]
        return (-0.5 * torch.sum(diff * diff, dim=-1)
                - torch.sum(torch.log(s)) - 0.5 * d * math.log(2.0 * math.pi))

    return Proposal(sample=sample, logp=logp,
                    scaled=lambda f: gaussian_random_walk_proposal(
                        scales * f),
                    takes_state_split=True)


def isotropic_gaussian_target(std) -> Target:
    """Isotropic Gaussian target ``-0.5 sum(x^2) / std^2``
    (``distributions.rs:398-402``). Its CUDA form is the separable tier's
    ``isotropic_gaussian`` coordinate functor (``csrc/coord_targets.cuh``),
    ``std`` its parameter."""

    def logp(pos):
        return -0.5 * torch.sum(pos * pos, dim=-1) / (std * std)

    return Target(logp=logp, cuda_functor="isotropic_gaussian",
                  cuda_params=(float(std),))


def standard_normal() -> Target:
    """Standard normal target ``-0.5 * sum(x^2)`` (the reference's NUTS
    test fixture, ``nuts.rs:1024-1037``). Its CUDA form is the separable
    tier's ``standard_normal`` coordinate functor."""

    def logp(pos):
        return -0.5 * torch.sum(pos * pos, dim=-1)

    def grad(pos):
        return -pos

    return Target(logp=logp, grad=grad, cuda_functor="standard_normal")


def neal_funnel(scale: float = 3.0) -> Target:
    """Neal's funnel (``mini_mcmc_tpu/models/gaussian.py:231-283``): ``v ~
    N(0, scale^2)``, ``x_i | v ~ N(0, e^v)``, the state ``[v, x_1, ..,
    x_{D-1}]``. A hard target whose neck makes NUTS diverge. ``logp``,
    ``logp_batch`` and the analytic ``grad`` follow the JAX package's
    batch forms; the kernels run the ``neal_funnel`` functor
    (``csrc/targets.cuh:NealFunnel``, the JAX ``logp_dc`` term for term)
    at D in ``KERNEL_DIMS``, its one coefficient ``1 / scale^2``."""
    inv_s2 = 1.0 / (scale * scale)

    def logp(states):
        v = states[..., 0]
        x = states[..., 1:]
        d = x.shape[-1]
        return (-0.5 * v * v * inv_s2
                - 0.5 * torch.sum(x * x, dim=-1) * torch.exp(-v)
                - 0.5 * d * v)

    def grad(states):
        v = states[..., :1]
        x = states[..., 1:]
        d = x.shape[-1]
        e = torch.exp(-v)
        gv = (-v * inv_s2 + 0.5 * torch.sum(x * x, dim=-1, keepdim=True) * e
              - 0.5 * d)
        return torch.cat([gv, -x * e], dim=-1)

    return Target(logp=logp, logp_batch=logp, grad=grad,
                  cuda_functor="neal_funnel", cuda_params=(inv_s2,))
