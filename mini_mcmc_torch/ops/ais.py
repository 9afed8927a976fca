"""Annealed importance sampling (Neal 2001): normalizing constants.

Counterpart of ``mini_mcmc_tpu/ops/ais.py``. AIS anneals a population of
particles from a NORMALIZED Gaussian prior ``p0`` to the unnormalized
target along the geometric path

    f_beta(x) ∝ exp((1 - beta) * logp0(x) + beta * logp(x)),

``0 = beta_0 < beta_1 < ... < beta_K = 1``, with a few ``f_beta``-invariant
random-walk MH sweeps at each rung, and accumulates the importance weight

    log w = sum_k (beta_k - beta_{k-1}) * (logp(x_{k-1}) - logp0(x_{k-1})),

evaluated at the particle BEFORE the rung's transition. Because ``p0`` is
normalized, ``E[w] = Z`` for any schedule, and ``logsumexp(log_w) - log N``
estimates ``log Z``.

The population is one ``[N, D]`` lockstep batch and the anneal a Python
loop over the rungs (``lax.scan`` in the JAX package). The schedule's
float32 algebra (each ``beta``, ``1 - beta`` and ``beta_k - beta_{k-1}``)
is done on the host in numpy float32, as XLA does it on the device, and
enters the device ops as scalars: an anneal makes no device-to-host read
until its result. Nothing reduces across particles inside the loop.

A particle batch sharded over a chain mesh (a DTensor ``x0``, from
``parallel.shard_chains``) anneals each rank's own particles with the
draws of their global places and no collective; the log-Z ``logsumexp``
and the weight ESS gather the ``[N]`` weights after the loop (one
all-gather).

The Gaussian prior, the tempered-MH sweep and the systematic-resampling
strata here are the building blocks of the adaptive sampler too
(``ops/smc.py`` imports them): one implementation, two estimators.

Every function that draws has a form on given draws, so the CPU tests feed
it the JAX package's own: :func:`make_anneal`'s ``anneal.on_draws``, and
the sweeps of :func:`_make_tempered_mh` take their draws as tensors.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..parallel.collectives import chain_draw, gather_chains
from ..parallel.mesh import local_state
from ..runner import key_generator
from ..stats import split_cube
from ..utils.init import resolve_device

#: float32 strata (``(u + arange(n)) / n``) collapse above 2^24: distinct
#: strata would repeat, silently double-drawing some particles. Guarded in
#: every systematic-resampling call site.
_STRATA_CAP = 1 << 24


class AISResult(NamedTuple):
    #: consistent log-Z estimate: logsumexp(log_weights) - log N (0-d)
    log_z: torch.Tensor
    #: [N] per-particle log importance weights (E[exp] = Z, unbiased)
    log_weights: torch.Tensor
    #: [N, D] final particle positions (approximately target-distributed;
    #: resample by normalized weight for exact importance resampling)
    positions: torch.Tensor
    #: normalized importance-weight effective sample size in (0, 1]:
    #: (sum w)^2 / (N * sum w^2); low values mean the schedule is too
    #: coarse (add rungs or MH steps)
    weight_ess: torch.Tensor


def linear_betas(n_rungs: int) -> tuple:
    """The default anneal schedule: ``n_rungs`` equal steps ``0 -> 1``, the
    float32 values of ``jnp.linspace(0, 1, n_rungs + 1)[1:]`` (``i *
    float32(1 / n)``; ``torch.linspace`` rounds some of them otherwise)."""
    if n_rungs < 1:
        raise ValueError(f"n_rungs must be >= 1, got {n_rungs}")
    steps = np.arange(n_rungs + 1, dtype=np.float32) * np.float32(1 / n_rungs)
    return tuple(float(b) for b in steps[1:])


def _validate_betas(betas) -> tuple:
    """Shared schedule validation: strictly increasing, ends at 1.0
    (``beta_0 = 0`` implicit). A wrong bridge density returns silently
    wrong weights."""
    betas = tuple(float(b) for b in betas)
    if not betas or abs(betas[-1] - 1.0) > 1e-12:
        raise ValueError(f"betas must end at 1.0, got {betas!r}")
    if any(b2 <= b1 for b1, b2 in zip((0.0,) + betas, betas)):
        raise ValueError("betas must be strictly increasing in (0, 1], "
                         f"got {betas!r}")
    return betas


def _resolve_key(seed, key, device) -> torch.Generator:
    """The generator of a run: ``key`` (a ``torch.Generator`` or a
    :class:`~mini_mcmc_torch.runner.StepKey`), or one on ``device`` seeded
    with ``seed`` (0 by default). Exactly one of the two."""
    if key is None:
        return torch.Generator(device=device).manual_seed(
            0 if seed is None else seed)
    if seed is not None:
        raise ValueError("pass seed or key, not both")
    return key_generator(key)


def _constant(value, dim: int, device) -> Union[float, torch.Tensor]:
    """A scalar or ``[D]`` float32 setting: a Python float holding the
    float32 value for a scalar, else a ``[D]`` tensor on ``device``, copied
    without a stream synchronization."""
    arr = np.asarray(value, np.float32)
    if arr.ndim == 0:
        return float(arr)
    arr = np.array(np.broadcast_to(arr, (dim,)))  # a writable copy
    return torch.from_numpy(arr).to(device, non_blocking=True)


def _gaussian_prior(prior_mean, prior_std, dim: int, device):
    """Validated NORMALIZED Gaussian prior: ``(mean [D], std [D],
    prior_logp: [N, D] -> [N])`` on ``device``. The ``log_norm`` constant
    is load-bearing: it makes ``E[w] = Z`` rather than ``Z / Z_prior``.
    Validation and the constant use host numpy float32, as the JAX
    package's do."""
    mean_h = np.broadcast_to(np.asarray(prior_mean, np.float32), (dim,))
    std_h = np.broadcast_to(np.asarray(prior_std, np.float32), (dim,))
    if np.any(std_h <= 0):
        raise ValueError(f"prior_std must be positive, got {prior_std!r}")
    log_norm = float(
        -0.5 * dim * np.log(2.0 * np.pi) - np.sum(np.log(std_h))
    )
    mean = _constant(mean_h, dim, device)
    std = _constant(std_h, dim, device)

    def prior_logp(xs):  # [N, D] -> [N]
        return log_norm - 0.5 * torch.sum(((xs - mean) / std) ** 2, dim=-1)

    return mean, std, prior_logp


def _mh_draws(gen: torch.Generator, n_mh_steps: int, x: torch.Tensor,
              chains=None):
    """The proposal normals ``[M, N, D]`` and accept uniforms ``[M, N]``
    of ``n_mh_steps`` sweeps, on ``x``'s device (a shard's particles of
    the global draws under ``chains``)."""
    shape = (n_mh_steps,) + tuple(x.shape)
    f = dict(generator=gen, dtype=x.dtype, device=x.device)
    normals = chain_draw(chains, lambda s: torch.randn(s, **f), shape, 1)
    uniforms = chain_draw(chains, lambda s: torch.rand(s, **f), shape[:2], 1)
    return normals, uniforms


def _make_tempered_mh(target, prior_logp: Callable, sigma):
    """``f_beta``-invariant random-walk MH sweeps on given draws, shared by
    AIS and SMC: ``sweeps(x, lp_t, lp_p, beta, normals [M, N, D], uniforms
    [M, N]) -> (x, lp_t, lp_p)``, one sweep a row of the draws (from
    :func:`_mh_draws`). ``beta`` is a float32 value, a Python float or a
    0-d tensor. The accept is strict and selects with ``torch.where``."""

    def sweeps(x, lp_t, lp_p, beta, normals, uniforms):
        one_minus = 1.0 - beta
        for prop_noise, u in zip(normals, uniforms):
            prop = x + sigma * prop_noise
            plp_t = target.batch_logp(prop)
            plp_p = prior_logp(prop)
            log_acc = one_minus * (plp_p - lp_p) + beta * (plp_t - lp_t)
            acc = log_acc > torch.log(u)
            x = torch.where(acc[:, None], prop, x)
            lp_t = torch.where(acc, plp_t, lp_t)
            lp_p = torch.where(acc, plp_p, lp_p)
        return x, lp_t, lp_p

    return sweeps


def _systematic_indices(log_w, u, n: int, n_draws: int) -> torch.Tensor:
    """Stratified inverse-CDF indices of the systematic resampling scheme
    (one uniform ``u``, ``n_draws`` equal strata). Callers guard
    ``n_draws <= _STRATA_CAP``."""
    w = torch.softmax(log_w, dim=0)
    cdf = torch.cumsum(w, dim=0)
    strata = (u + torch.arange(n_draws, dtype=w.dtype, device=w.device)
              ) / n_draws
    return torch.searchsorted(cdf, strata).clamp_(max=n - 1)


def ais_log_z(
    target,
    n_particles: int,
    dim: int,
    *,
    betas: Union[int, Sequence[float]] = 64,
    n_mh_steps: int = 2,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    seed: Optional[int] = None,
    key=None,
    device="cuda",
) -> AISResult:
    """Estimate ``log Z`` of an unnormalized ``target`` by AIS.

    Args:
        target: the unnormalized target (``batch_logp`` is used).
        n_particles: population size N (one lockstep ``[N, D]`` batch).
        dim: target dimension D.
        betas: an int (rung count for the default linear schedule) or an
            explicit increasing schedule ending at 1.0 (``beta_0 = 0`` is
            implicit). More rungs lower the weight variance, not the mean.
        n_mh_steps: ``f_beta``-invariant random-walk MH steps per rung.
        proposal_std: MH random-walk scale (scalar or per-dimension [D]).
        prior_mean / prior_std: the normalized Gaussian prior
            ``N(prior_mean, diag(prior_std^2))`` (scalar or [D] each).
        seed / key: the randomness (at most one; ``seed`` defaults to 0):
            ``key`` a ``torch.Generator`` on ``device`` or a
            :class:`~mini_mcmc_torch.runner.StepKey`.
        device: where the particles live (``"cuda"`` by default; raises
            without a GPU).

    Returns an :class:`AISResult` of tensors on ``device``. Check
    ``weight_ess`` before trusting ``log_z``. For repeated estimates of
    one configuration build the loop once with :func:`make_anneal`.
    """
    if n_particles < 2:
        raise ValueError(f"n_particles must be >= 2, got {n_particles}")
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    if isinstance(betas, int):
        betas = linear_betas(betas)
    device = resolve_device(device)
    gen = _resolve_key(seed, key, device)
    mean, std, _ = _gaussian_prior(prior_mean, prior_std, dim, device)
    anneal = make_anneal(target, betas, n_mh_steps=n_mh_steps,
                         proposal_std=proposal_std, prior_mean=prior_mean,
                         prior_std=prior_std)
    x0 = mean + std * torch.randn((n_particles, dim), generator=gen,
                                  dtype=torch.float32, device=device)
    return _ais_result(*anneal(x0, gen))


def _ais_result(x, log_w) -> AISResult:
    """The estimate and the weight ESS of an anneal's particles and
    weights: the only cross-particle reductions, once, after the loop (a
    sharded anneal's weights gathered first, one all-gather)."""
    local, chains, _ = split_cube(log_w)
    log_w = gather_chains(local, chains)
    n = log_w.shape[0]
    log_z = torch.logsumexp(log_w, dim=0) - math.log(n)
    w = torch.exp(log_w - torch.max(log_w))
    ess = torch.sum(w) ** 2 / (n * torch.sum(w * w))
    return AISResult(log_z, log_w, x, ess)


def resample(log_weights, positions, key,
             n_draws: Optional[int] = None) -> torch.Tensor:
    """Systematic importance resampling: weighted particles -> an
    unweighted ``[n_draws, D]`` sample of the target.

    One uniform from ``key`` (a ``torch.Generator`` or a
    :class:`~mini_mcmc_torch.runner.StepKey`) and stratified inverse-CDF
    lookup: particle i is drawn ``floor(N * W_i + u)`` times or once more.
    Runs on the generator's device; numpy inputs go there."""
    gen = key_generator(key)
    log_w = torch.as_tensor(log_weights, device=gen.device)
    n = log_w.shape[0]
    if n_draws is None:
        n_draws = n
    if n_draws < 1:
        raise ValueError(f"n_draws must be >= 1, got {n_draws}")
    if n_draws > _STRATA_CAP:
        raise ValueError(
            f"n_draws={n_draws} exceeds the float32 strata resolution "
            f"(2^24 = {_STRATA_CAP}): distinct strata would collapse and "
            "silently double-draw particles. Resample in <= 2^24 blocks."
        )
    u = torch.rand((), generator=gen, dtype=log_w.dtype, device=gen.device)
    idx = _systematic_indices(log_w, u, n, n_draws)
    return torch.as_tensor(positions, device=gen.device)[idx]


def make_anneal(
    target,
    betas: Sequence[float],
    *,
    n_mh_steps: int = 2,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
):
    """Build the anneal ``anneal(x0 [N, D], key) -> (x [N, D], log_weights
    [N])``, ``key`` a ``torch.Generator`` on ``x0``'s device or a
    :class:`~mini_mcmc_torch.runner.StepKey`, and its form on given draws
    ``anneal.on_draws(x0, normals [K, M, N, D], uniforms [K, M, N])``
    (rung k's M sweeps' proposal normals and accept uniforms). An ``x0``
    sharded over a chain mesh (a DTensor) anneals each rank's particles,
    with no collective, and returns DTensors.

    The loop of :func:`ais_log_z`: nothing inside reduces across particles
    and nothing is read back to the host. ``x0`` MUST be distributed as
    the ``N(prior_mean, diag(prior_std^2))`` prior for the weights to mean
    anything.
    """
    betas = _validate_betas(betas)
    if n_mh_steps < 0:
        raise ValueError(f"n_mh_steps must be >= 0, got {n_mh_steps}")
    # the schedule's float32 algebra on the host, as the JAX package's
    # jnp.asarray(betas, float32) and jnp.diff
    beta_steps = np.asarray(betas, np.float32)
    dbeta = np.diff(np.concatenate([np.zeros(1, np.float32), beta_steps]))
    rungs = [(float(b), float(db)) for b, db in zip(beta_steps, dbeta)]

    def run(x0, rung_draws):
        _, _, prior_logp = _gaussian_prior(prior_mean, prior_std,
                                           x0.shape[1], x0.device)
        sigma = _constant(proposal_std, x0.shape[1], x0.device)
        sweeps = _make_tempered_mh(target, prior_logp, sigma)
        x, lp_t, lp_p = x0, target.batch_logp(x0), prior_logp(x0)
        log_w = torch.zeros(x0.shape[0], dtype=torch.float32,
                            device=x0.device)
        for k, (beta, d_beta) in enumerate(rungs):
            # the weight increment at the PRE-transition particle:
            # log f_k(x_{k-1}) - log f_{k-1}(x_{k-1}) = d_beta (lp_t - lp_p)
            log_w = log_w + d_beta * (lp_t - lp_p)
            x, lp_t, lp_p = sweeps(x, lp_t, lp_p, beta, *rung_draws(k, x))
        return x, log_w

    def anneal(x0, key):
        gen = key_generator(key)
        local, layout = local_state(x0)
        if layout is not None and layout.state is not None:
            raise ValueError(
                "make_anneal's anneal takes each particle's whole state: "
                "an x0 split over a 'state' axis (shard_state_dim=True) "
                "runs only on HMC and MALA with use_pallas=False and on "
                "HMC(use_pallas='separable'); shard the particles alone "
                "(shard_chains or shard_state_dim=False)")
        chains = None if layout is None else layout.chains
        x, log_w = run(local, lambda k, x: _mh_draws(gen, n_mh_steps, x,
                                                     chains))
        if layout is None:
            return x, log_w
        return layout.wrap_chains(x), layout.wrap_chains(log_w)

    def on_draws(x0, normals, uniforms):
        return run(x0, lambda k, x: (normals[k], uniforms[k]))

    anneal.on_draws = on_draws
    return anneal
