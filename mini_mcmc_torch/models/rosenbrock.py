"""Rosenbrock targets (2D and N-D).

Counterpart of ``mini_mcmc_tpu/models/rosenbrock.py``, with the analytic
gradients in the same arithmetic order. ``rosenbrock_nd`` names its CUDA
functor (``csrc/targets.cuh``), so the hand-written kernels can run it.
"""

from __future__ import annotations

import torch

from .base import Target


def rosenbrock2d(a=1.0, b=100.0) -> Target:
    """2D Rosenbrock: ``logp = -((a - x)^2 + b * (y - x^2)^2)``."""

    def logp(pos):
        x, y = pos[..., 0], pos[..., 1]
        return -((a - x) ** 2 + b * (y - x * x) ** 2)

    def grad(pos):
        x, y = pos[..., 0], pos[..., 1]
        dyx = y - x * x
        gx = 2.0 * (a - x) + 4.0 * b * x * dyx
        gy = -2.0 * b * dyx
        return torch.stack([gx, gy], dim=-1)

    return Target(logp=logp, grad=grad)


def rosenbrock_nd() -> Target:
    """N-D Rosenbrock:
    ``logp = -sum_i [100*(x_{i+1} - x_i^2)^2 + (1 - x_i)^2]``."""

    def logp(pos):
        low = pos[..., :-1]
        high = pos[..., 1:]
        term_1 = 100.0 * (high - low * low) ** 2
        term_2 = (1.0 - low) ** 2
        return -torch.sum(term_1 + term_2, dim=-1)

    def grad(pos):
        low = pos[..., :-1]
        high = pos[..., 1:]
        d = high - low * low
        zero = torch.zeros_like(pos[..., :1])
        low_contrib = 400.0 * d * low + 2.0 * (1.0 - low)
        high_contrib = -200.0 * d
        return (torch.cat([low_contrib, zero], dim=-1)
                + torch.cat([zero, high_contrib], dim=-1))

    return Target(logp=logp, grad=grad, cuda_functor="rosenbrock_nd")
