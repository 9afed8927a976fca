"""Discrete distributions and integer-state proposals (counterpart of
``mini_mcmc_tpu/models/discrete.py``).

States are integer tensors (``int32``); the MH kernel keeps them integer
and its cached log density float32. ``poisson_target`` names the
``poisson`` CUDA functor (``csrc/targets.cuh``), which calls CUDA's
``lgammaf`` where this module calls ``torch.lgamma``: the JAX package's
Lanczos ``utils/mathx.py`` exists only because Mosaic cannot lower
``lax.lgamma``, and is not ported. ``random_walk_int_proposal`` names the
``random_walk_int`` functor (``csrc/proposals.cuh``). ``Categorical`` and
``binomial_target`` are plain PyTorch only.
"""

from __future__ import annotations

import math

import torch

from .base import Proposal, Target

#: the walk's clip bounds reach the kernel as float32 coefficients, exact
#: for integers up to 2**24 in magnitude
_CLIP_EXACT = 1 << 24


class Categorical:
    """Categorical distribution over ``len(probs)`` categories (reference
    ``distributions.rs:421-477``), normalized at construction."""

    def __init__(self, probs):
        probs = torch.as_tensor(probs, dtype=torch.float32)
        self.probs = probs / torch.sum(probs)

    def sample(self, gen, shape=()):
        n = math.prod(shape)
        draws = torch.multinomial(self.probs, max(n, 1), replacement=True,
                                  generator=gen)
        return draws[:n].reshape(shape)

    def logp(self, index):
        index = torch.as_tensor(index)
        k = self.probs.shape[0]
        in_range = (index >= 0) & (index < k)
        safe = torch.clamp(index, 0, k - 1).long()
        return torch.where(in_range, torch.log(self.probs[safe]),
                           torch.tensor(-math.inf))

    def target(self) -> Target:
        """Integer-state target: ``logp([k]) = logp(k)``
        (``distributions.rs:471-477``)."""
        return Target(logp=lambda state: self.logp(state[..., 0]))


def poisson_target(lam) -> Target:
    """Poisson(``lam``) over 1-dim integer states: ``logp(k) = k ln(lam) -
    lam - ln(k!)``, -inf for k < 0 (reference
    ``tests/metrohast_poisson_test.rs:23-35``)."""
    lam = float(lam)
    log_lam = math.log(lam)

    def logp(state):
        k = state[..., 0]
        kf = k.to(torch.float32)
        lp = kf * log_lam - lam - torch.lgamma(kf + 1.0)
        return torch.where(k < 0, -math.inf, lp)

    return Target(logp=logp, cuda_functor="poisson",
                  cuda_params=(log_lam, lam))


def binomial_target(n, p) -> Target:
    """Binomial(``n``, ``p``) over 1-dim integer states, -inf outside
    [0, n] (``metrohast_poisson_test.rs:150-176``)."""
    log_p, log1mp = math.log(p), math.log1p(-p)
    nf = float(n)
    log_n_fact = math.lgamma(nf + 1.0)

    def logp(state):
        k = state[..., 0]
        kf = k.to(torch.float32)
        log_choose = (log_n_fact - torch.lgamma(kf + 1.0)
                      - torch.lgamma(nf - kf + 1.0))
        lp = log_choose + kf * log_p + (nf - kf) * log1mp
        return torch.where((k < 0) | (k > n), -math.inf, lp)

    return Target(logp=logp)


def int_walk(current, up, clip_low, clip_high=None):
    """``current`` plus 1 where ``up``, else minus 1, reflected at
    ``clip_low`` (and ``clip_high``): the walk's arithmetic, shared by its
    ``sample`` and the MH kernel's plain twin."""
    new = current + torch.where(up, 1, -1).to(current.dtype)
    new = torch.clamp(new, min=clip_low)
    if clip_high is not None:
        new = torch.clamp(new, max=clip_high)
    return new


def random_walk_int_proposal(clip_low=0, clip_high=None) -> Proposal:
    """Symmetric +-1 integer random walk, reflecting at ``clip_low`` (and
    optionally ``clip_high``), as ``PoissonRandomWalk``
    (``metrohast_poisson_test.rs:52-105``). It declares itself symmetric
    with ``logp = ln(1/2)`` even at the reflecting boundary, the
    reference's quirk (``mini_mcmc_tpu/models/discrete.py:141-143``)."""
    for v in (clip_low, clip_high):
        if v is not None and abs(int(v)) >= _CLIP_EXACT:
            raise ValueError(f"clip bounds must lie within +-2**24; got {v}")

    def sample(gen, current):
        up = torch.rand(current.shape, generator=gen,
                        device=current.device) < 0.5
        return int_walk(current, up, clip_low, clip_high)

    def logp(frm, to):
        del to
        return torch.full(frm.shape[:-1], math.log(0.5), dtype=torch.float32,
                          device=frm.device)

    has_high = clip_high is not None
    return Proposal(sample=sample, logp=logp, symmetric=True,
                    cuda_functor="random_walk_int",
                    cuda_params=(float(clip_low),
                                 float(clip_high) if has_high else 0.0,
                                 float(has_high)),
                    takes_state_split=True)
