"""Batched elliptical slice sampling (Murray, Adams & MacKay 2010).

Counterpart of ``mini_mcmc_tpu/ops/elliptical.py``: for ``p(x) ~ N(x; mu,
Sigma) L(x)``, each update draws ``nu ~ N(0, Sigma)`` and slice-samples
the angle on the ellipse ``x(theta) = (x - mu) cos theta + nu sin theta +
mu``, which passes through the current state and leaves the prior
invariant, so only the likelihood enters the accept test and nothing is
tuned. The angle bracket ``[theta - 2 pi, theta]`` shrinks toward 0
geometrically.

All chains advance in lockstep: the shrinkage is one masked loop over the
batch with one likelihood call an iteration (``ops/slice.py:masked_loop``,
testing "any chain pending" on the host every ``TEST_EVERY`` iterations;
the update's ``max_shrink`` uniforms are drawn up front, so the result
does not depend on that). The prior draw is one ``[C, D] @ [D, D]``
``torch.matmul`` against the prior's Cholesky factor, as the JAX package
leaves it to XLA. :func:`elliptical_step` takes its draws as inputs, so a
test can hand it the JAX package's own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.collectives import chain_draw
from ..runner import StepKey, make_scan_block_fn
from .slice import TEST_EVERY, masked_loop


class EllipticalState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    loglik: torch.Tensor  # [C] cached likelihood log density (not the prior)


class EllipticalDraws(NamedTuple):
    """One update's draws for ``C`` chains."""

    normal: torch.Tensor  # [C, D] standard normals (nu = normal @ chol.T)
    u_height: torch.Tensor  # [C] the slice height's uniform
    u_angle: torch.Tensor  # [C] the first angle's uniform
    u_shrink: torch.Tensor  # [max_shrink, C] shrinkage iteration i's


def _as_scale(prior_scale, dim: int, dtype, device=None) -> torch.Tensor:
    """The prior's ``[D, D]`` lower Cholesky factor from a scalar std, a
    ``[D]`` std vector or the ``[D, D]`` factor itself
    (``elliptical.py:60-87``)."""
    scale = torch.as_tensor(prior_scale, dtype=dtype, device=device)
    if scale.dim() == 0:
        return scale * torch.eye(dim, dtype=dtype, device=device)
    if scale.dim() == 1:
        if scale.shape[0] != dim:
            raise ValueError(f"prior scale vector has {scale.shape[0]} "
                             f"entries for a {dim}-D state")
        return torch.diag(scale)
    if scale.dim() == 2:
        if tuple(scale.shape) != (dim, dim):
            raise ValueError(f"prior Cholesky must be [{dim}, {dim}], got "
                             f"{tuple(scale.shape)}")
        return scale
    raise ValueError("prior scale must be a scalar, [D], or [D, D]; got "
                     f"shape {tuple(scale.shape)}")


def elliptical_draws(gen: torch.Generator, n_chains: int, dim: int,
                     max_shrink: int, like: torch.Tensor,
                     chains=None) -> EllipticalDraws:
    """An update's draws from ``gen``, on ``like``'s device (a shard's
    rows of the global draws under ``chains``)."""
    f = dict(generator=gen, dtype=like.dtype, device=like.device)

    def rand(shape, axis=0):
        return chain_draw(chains, lambda s: torch.rand(s, **f), shape, axis)

    return EllipticalDraws(
        chain_draw(chains, lambda s: torch.randn(s, **f), (n_chains, dim)),
        rand((n_chains,)), rand((n_chains,)), rand((max_shrink, n_chains), 1))


def elliptical_step(loglik, state: EllipticalState, mu: torch.Tensor,
                    chol: torch.Tensor, draws: EllipticalDraws,
                    test_every: int = TEST_EVERY,
                    chains=None) -> EllipticalState:
    """One elliptical slice update of every chain on given draws
    (``elliptical.py:120-168``): prior mean ``mu [D]``, Cholesky ``chol
    [D, D]``; the same for any ``test_every``."""
    pos = state.positions
    c = pos.shape[0]
    nu = torch.matmul(draws.normal, chol.T)
    centered = pos - mu
    logy = state.loglik + torch.log(draws.u_height)
    two_pi = torch.tensor(2.0 * math.pi, dtype=pos.dtype, device=pos.device)
    theta0 = two_pi * draws.u_angle

    def body(carry, it):
        theta, t_min, t_max, x_new, ll_new, pending = carry
        cand = (centered * torch.cos(theta)[:, None]
                + nu * torch.sin(theta)[:, None] + mu)
        ll_cand = loglik.batch_logp(cand)
        accept = pending & (ll_cand > logy)
        x_new = torch.where(accept[:, None], cand, x_new)
        ll_new = torch.where(accept, ll_cand, ll_new)
        pending = pending ^ accept  # accept implies pending
        # the rejected angle becomes the bracket's edge on its side of 0
        below = pending & (theta < 0.0)
        t_min = torch.where(below, theta, t_min)
        t_max = torch.where(pending ^ below, theta, t_max)
        theta = t_min + draws.u_shrink[it] * (t_max - t_min)
        return theta, t_min, t_max, x_new, ll_new, pending

    pending0 = torch.ones((c,), dtype=torch.bool, device=pos.device)
    carry = masked_loop(
        body, (theta0, theta0 - two_pi, theta0, pos, state.loglik, pending0),
        lambda carry: carry[5].any(), draws.u_shrink.shape[0], test_every,
        chains)
    return EllipticalState(carry[3], carry[4])


def elliptical_kernel(loglik, *, prior_mean=0.0, prior_scale=1.0,
                      max_shrink: int = 32, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for batched elliptical slice sampling.

    ``loglik``: the likelihood ``L(x)`` as a Target (only ``batch_logp``
    is used); the Gaussian prior is not part of it. ``prior_mean``: a
    scalar or ``[D]``; ``prior_scale``: a scalar std, ``[D]`` stds or the
    ``[D, D]`` lower Cholesky factor of the covariance. ``max_shrink``
    caps the angle shrinkage (a capped chain keeps its state).
    ``steps_per_call`` > 1 attaches the K-step ``block_fn``.
    """
    if max_shrink < 1:
        raise ValueError(f"max_shrink must be >= 1, got {max_shrink}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    prior = {}  # (mu, chol) per (device, dtype, D)

    def _prior(like: torch.Tensor):
        k = (like.device, like.dtype, like.shape[1])
        if k not in prior:
            dim = like.shape[1]
            mu = torch.as_tensor(prior_mean, dtype=like.dtype,
                                 device=like.device).expand(dim)
            prior[k] = (mu, _as_scale(prior_scale, dim, like.dtype,
                                      like.device))
        return prior[k]

    def init_fn(positions: torch.Tensor) -> EllipticalState:
        _prior(positions)  # a malformed prior raises here
        return EllipticalState(positions, loglik.batch_logp(positions))

    def step_fn(state: EllipticalState, key: StepKey) -> EllipticalState:
        c, d = state.positions.shape
        mu, chol = _prior(state.positions)
        draws = elliptical_draws(key.generator, c, d, max_shrink,
                                 state.positions, key.chains)
        return elliptical_step(loglik, state, mu, chol, draws,
                               chains=key.chains)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
