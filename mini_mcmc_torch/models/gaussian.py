"""Gaussian targets (counterpart of ``mini_mcmc_tpu/models/gaussian.py``).

``diffable_gaussian2d`` evaluates the 2x2 quadratic scalar-wise with
Python-float coefficients, in the operation order of the JAX package's
chains-on-lanes forms (``logp_dc``/``grad_dc``), which the fused kernels on
both sides run. It names its CUDA functor (``csrc/targets.cuh``) and hands
the same seven coefficients to it in ``Target.cuda_params``.
"""

from __future__ import annotations

import math

import torch

from .base import Target


def diffable_gaussian2d(mean, cov) -> Target:
    """Normalized 2D Gaussian for gradient-based samplers
    (``DiffableGaussian2D``, reference ``distributions.rs:212-316``):
    ``logp = norm_const - 0.5 (x - m)^T S^-1 (x - m)``."""
    m0, m1 = (float(v) for v in mean)
    (a, b), (c, d) = ((float(v) for v in row) for row in cov)
    det = a * d - b * c
    ic00, ic01, ic10, ic11 = d / det, -b / det, -c / det, a / det
    nc = -(2.0 * math.log(2.0 * math.pi) + math.log(det)) / 2.0
    ic_cross = ic01 + ic10

    def logp(pos):
        d0 = pos[..., 0] - m0
        d1 = pos[..., 1] - m1
        quad = ic00 * d0 * d0 + ic_cross * d0 * d1 + ic11 * d1 * d1
        return nc - 0.5 * quad

    def grad(pos):
        d0 = pos[..., 0] - m0
        d1 = pos[..., 1] - m1
        g0 = -(ic00 * d0 + ic01 * d1)
        g1 = -(ic10 * d0 + ic11 * d1)
        return torch.stack([g0, g1], dim=-1)

    return Target(logp=logp, grad=grad, cuda_functor="gaussian2d",
                  cuda_params=(m0, m1, ic00, ic01, ic10, ic11, nc))


def standard_normal() -> Target:
    """Standard normal target ``-0.5 * sum(x^2)`` (the reference's NUTS
    test fixture, ``nuts.rs:1024-1037``)."""

    def logp(pos):
        return -0.5 * torch.sum(pos * pos, dim=-1)

    def grad(pos):
        return -pos

    return Target(logp=logp, grad=grad)
