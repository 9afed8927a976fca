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
does not depend on that). The prior draw multiplies the normals
elementwise by a scalar or ``[D]`` std (bit-equal to the JAX package's
diagonal ``[C, D] @ [D, D]`` product, without the ``[D, D]`` matrix), or
is one ``torch.matmul`` against a ``[D, D]`` Cholesky factor, as the JAX
package leaves it to XLA. :func:`elliptical_step` takes its draws as
inputs, so a test can hand it the JAX package's own.

Under a state split (``key.state``: D split over a ``"state"`` axis) each
rank moves its D-slice of every chain on the same ellipse: it draws its
chains' rows of the global ``[C, D]`` normals, and its columns of ``nu``
are the prior's on the slice. A scalar or ``[D]`` scale multiplies the
slice's normals elementwise; a ``[D, D]`` factor multiplies the rows'
whole normals by the rank's rows of the factor, with no collective.
``mu`` is sliced alike. The likelihood runs on a DTensor view of the
slice (``parallel.mesh.SliceTarget``), its sum over D whole on every
rank: one all-reduce a shrink iteration (and one at the state's start),
besides the chain axis's scalar loop tests. Every shard of a chain then
takes the same decisions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.collectives import chain_draw, split
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, make_scan_block_fn
from .slice import TEST_EVERY, masked_loop


class EllipticalState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    loglik: torch.Tensor  # [C] cached likelihood log density (not the prior)


class EllipticalDraws(NamedTuple):
    """One update's draws for ``C`` chains."""

    #: [C, D] standard normals (nu = normal * std or normal @ chol.T), the
    #: chains' whole rows under a state split
    normal: torch.Tensor
    u_height: torch.Tensor  # [C] the slice height's uniform
    u_angle: torch.Tensor  # [C] the first angle's uniform
    u_shrink: torch.Tensor  # [max_shrink, C] shrinkage iteration i's


def _as_scale(prior_scale, dim: int, dtype, device=None) -> torch.Tensor:
    """The prior's ``[D, D]`` lower Cholesky factor from a scalar std, a
    ``[D]`` std vector or the ``[D, D]`` factor itself
    (``elliptical.py:60-87``); the kernel calls it only to name a malformed
    scale, and multiplies by a scalar or ``[D]`` std elementwise."""
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


def _slice_prior(prior_mean, prior_scale, n_dim: int, d0: int, d: int,
                 dtype, device):
    """``(mu, scale)`` of the D-slice ``[d0, d0 + d)`` of an ``n_dim``-D
    state (the whole state at ``d0 = 0, d = n_dim``): the mean's columns,
    and the scale as what multiplies the draws there, a scalar or the
    ``[d]`` stds elementwise, or the Cholesky factor's ``[d, n_dim]``
    rows."""
    mu = torch.as_tensor(prior_mean, dtype=dtype, device=device)
    mu = mu.expand(n_dim).narrow(0, d0, d)
    scale = torch.as_tensor(prior_scale, dtype=dtype, device=device)
    if scale.dim() > 2 or any(n != n_dim for n in scale.shape):
        _as_scale(scale, n_dim, dtype, device)  # raises, naming it
    return mu, scale if scale.dim() == 0 else scale.narrow(0, d0, d)


def elliptical_step(loglik, state: EllipticalState, mu: torch.Tensor,
                    scale: torch.Tensor, draws: EllipticalDraws,
                    test_every: int = TEST_EVERY,
                    chains=None, d0: int = 0) -> EllipticalState:
    """One elliptical slice update of every chain on given draws
    (``elliptical.py:120-168``): prior mean ``mu [D]`` and ``scale`` a
    scalar std, ``[D]`` stds or the ``[D, D]`` Cholesky factor; the same
    for any ``test_every``. On a rank's D-slice from column ``d0``
    (``loglik`` then a ``SliceTarget``), ``mu`` and ``scale`` are the
    slice's (:func:`_slice_prior`) and ``draws.normal`` its chains' whole
    rows."""
    pos = state.positions
    c, d = pos.shape
    if scale.dim() < 2:
        nu = draws.normal.narrow(1, d0, d) * scale
    else:
        nu = torch.matmul(draws.normal, scale.T)
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
    ``init_fn(positions, state=None)`` takes the ``StateGroup`` of a
    rank's D-slice.
    """
    if max_shrink < 1:
        raise ValueError(f"max_shrink must be >= 1, got {max_shrink}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    prior = {}  # (mu, scale) per (device, dtype, D, first column)

    def _prior(like: torch.Tensor, st=None):
        """``(mu, scale)`` of ``like``'s columns of the state
        (:func:`_slice_prior`): the whole state, or a split ``st``'s
        slice."""
        n_dim, d0 = (st.n_dim, st.d0) if split(st) else (like.shape[1], 0)
        k = (like.device, like.dtype, like.shape[1], d0)
        if k not in prior:
            prior[k] = _slice_prior(prior_mean, prior_scale, n_dim, d0,
                                    like.shape[1], like.dtype, like.device)
        return prior[k]

    def init_fn(positions: torch.Tensor, state=None) -> EllipticalState:
        _prior(positions, state)  # a malformed prior raises here
        tgt = SliceTarget(loglik, state) if split(state) else loglik
        return EllipticalState(positions, tgt.batch_logp(positions))

    def step_fn(state: EllipticalState, key: StepKey) -> EllipticalState:
        c, d = state.positions.shape
        st = key.state
        mu, scale = _prior(state.positions, st)
        n_dim, d0, tgt = ((st.n_dim, st.d0, SliceTarget(loglik, st))
                          if split(st) else (d, 0, loglik))
        # the chains' whole rows of the normals
        draws = elliptical_draws(key.generator, c, n_dim, max_shrink,
                                 state.positions, key.chains)
        return elliptical_step(tgt, state, mu, scale, draws,
                               chains=key.chains, d0=d0)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
