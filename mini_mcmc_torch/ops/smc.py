"""Adaptive sequential Monte Carlo sampler (Del Moral et al. 2006).

Counterpart of ``mini_mcmc_tpu/ops/smc.py``: the self-tuning sibling of
:mod:`~mini_mcmc_torch.ops.ais`. Each stage chooses the next ``beta`` as
the largest one keeping the incremental importance weights' effective
sample size at ``target_ess`` (a 40-iteration bisection), systematically
resamples the population back to uniform weights and rejuvenates it with
tempered MH sweeps at the new ``beta``. The normalizing-constant estimate
accumulates one self-normalized increment a stage,

    log Z = sum_j [ logsumexp(dw_j) - log N ],
    dw_j = (beta_{j+1} - beta_j) * (logp(x) - logp0(x)).

The stage loop runs on the host (a ``while_loop`` with ``lax.cond`` in the
JAX package). Its control flow needs the device once a stage: one read of
two flags, whether the full jump to ``beta = 1`` keeps the ESS at the
target and whether the previous stage stalled. The bisection runs on the
device with ``torch.where`` over a float32 0-d ``(lo, hi)`` and only when
the full jump fails. The prior, the tempered-MH sweep and the resampling
strata are imported from ``ops/ais.py``: one implementation, two
estimators.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..runner import key_generator
from ..utils.init import resolve_device
from .ais import (
    _STRATA_CAP,
    _constant,
    _gaussian_prior,
    _make_tempered_mh,
    _mh_draws,
    _resolve_key,
    _systematic_indices,
)

#: the bisection's iterations for the next beta
_BISECT_STEPS = 40


class SMCResult(NamedTuple):
    #: accumulated log normalizing-constant estimate (0-d)
    log_z: torch.Tensor
    #: [N, D] final particle population (uniformly weighted: resampling
    #: happens every stage)
    positions: torch.Tensor
    #: realized number of tempering stages (Python int)
    n_stages: int
    #: [n_stages] the adaptive schedule actually taken (ends at 1.0)
    betas: torch.Tensor
    #: [n_stages] incremental-weight ESS fraction at each stage (the
    #: bisection pins it at ``target_ess`` except for the final jump)
    stage_ess: torch.Tensor


class Stage(NamedTuple):
    """One stage's result (``make_smc_run``'s ``run.stage``)."""

    x: torch.Tensor  # [N, D] resampled, then rejuvenated
    lp_t: torch.Tensor  # [N] target logp at x
    lp_p: torch.Tensor  # [N] prior logp at x
    beta: torch.Tensor  # 0-d float32, the new beta
    log_z_increment: torch.Tensor  # 0-d: logsumexp(dw) - log N
    ess: torch.Tensor  # 0-d: the incremental weights' ESS fraction
    stalled: torch.Tensor  # 0-d bool: the bisection could not move beta
    idx: torch.Tensor  # [N] the systematic resampling's indices


def _ess_frac(dw, n_f: float):
    """Normalized ESS in (0, 1] of incremental log weights [N]."""
    w = torch.softmax(dw, dim=0)
    return 1.0 / (n_f * torch.sum(w * w))


def make_smc_run(
    target,
    *,
    n_mh_steps: int = 5,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    target_ess: float = 0.8,
    max_stages: int = 256,
):
    """Build the adaptive anneal ``run(x0 [N, D], key) -> (x, final_beta,
    log_z, n_stages, betas_buf, ess_buf)``, ``key`` a ``torch.Generator``
    on ``x0``'s device or a :class:`~mini_mcmc_torch.runner.StepKey`.

    ``n_stages`` is a Python int; the rest are tensors on ``x0``'s device.
    ``x0`` MUST be distributed as the ``N(prior_mean,
    diag(prior_std^2))`` prior. ``betas_buf`` / ``ess_buf`` are
    ``[max_stages]`` NaN-padded; slice with ``n_stages``. A stalled anneal
    (float32 cannot represent a small-enough beta increment) stops with
    ``final_beta < 1`` and ``n_stages < max_stages``; :func:`smc_log_z`
    turns both that and a truncated anneal into errors.

    ``run.stage(x, lp_t, lp_p, beta, u, normals [M, N, D], uniforms [M,
    N])`` is one stage on given draws (``u`` the resampling's uniform),
    returning a :class:`Stage`. ``run.host_reads`` counts the run's
    device-to-host reads (one a stage).
    """
    if n_mh_steps < 0:
        raise ValueError(f"n_mh_steps must be >= 0, got {n_mh_steps}")
    if not 0.0 < target_ess < 1.0:
        raise ValueError(f"target_ess must be in (0, 1), got {target_ess}")
    if max_stages < 1:
        raise ValueError(f"max_stages must be >= 1, got {max_stages}")

    def parts(x):
        _, _, prior_logp = _gaussian_prior(prior_mean, prior_std,
                                           x.shape[1], x.device)
        sigma = _constant(proposal_std, x.shape[1], x.device)
        return prior_logp, _make_tempered_mh(target, prior_logp, sigma)

    def next_beta(delta, beta, full: bool, n_f: float):
        """The largest beta in (beta, 1] whose incremental weights keep
        the ESS >= target_ess: 1 when the full jump does, else the
        bisection's lower end (float32 ``mid = 0.5 (lo + hi)``)."""
        if full:
            return torch.ones((), dtype=torch.float32, device=delta.device)
        lo, hi = beta, torch.ones_like(beta)
        for _ in range(_BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            ok = _ess_frac((mid - beta) * delta, n_f) >= target_ess
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return lo

    def full_jump(delta, beta, n_f: float):
        return _ess_frac((1.0 - beta) * delta, n_f) >= target_ess

    def stage_on(sweeps, x, lp_t, lp_p, beta, full: bool, u, normals,
                 uniforms) -> Stage:
        n = x.shape[0]
        delta = lp_t - lp_p  # [N]
        new_beta = next_beta(delta, beta, full, float(n))
        # stall: one float32 ulp of beta already drops the ESS below the
        # target, so the bisection converged back to beta
        stalled = (torch.zeros((), dtype=torch.bool, device=x.device)
                   if full else new_beta <= beta)
        dw = (new_beta - beta) * delta
        increment = torch.logsumexp(dw, dim=0) - math.log(n)
        ess = _ess_frac(dw, float(n))
        # systematic resample back to uniform weights, then tempered-MH
        # rejuvenation at the NEW beta
        idx = _systematic_indices(dw, u, n, n)
        x, lp_t, lp_p = sweeps(x[idx], lp_t[idx], lp_p[idx], new_beta,
                               normals, uniforms)
        return Stage(x, lp_t, lp_p, new_beta, increment, ess, stalled, idx)

    def stage(x, lp_t, lp_p, beta, u, normals, uniforms) -> Stage:
        _, sweeps = parts(x)
        beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
        full = bool(full_jump(lp_t - lp_p, beta, float(x.shape[0])))
        return stage_on(sweeps, x, lp_t, lp_p, beta, full, u, normals,
                        uniforms)

    def run(x0, key):
        gen = key_generator(key)
        n, dev = x0.shape[0], x0.device
        prior_logp, sweeps = parts(x0)
        x, lp_t, lp_p = x0, target.batch_logp(x0), prior_logp(x0)
        beta = torch.zeros((), dtype=torch.float32, device=dev)
        log_z = torch.zeros((), dtype=torch.float32, device=dev)
        stalled = torch.zeros((), dtype=torch.bool, device=dev)
        betas_buf = torch.full((max_stages,), math.nan, dtype=torch.float32,
                               device=dev)
        ess_buf = torch.full_like(betas_buf, math.nan)
        j = 0
        while j < max_stages:
            # the stage's one read: the full-jump test and the loop's exit
            # test (the last stage stalled, or beta reached 1)
            full_t = full_jump(lp_t - lp_p, beta, float(n))
            full, stop = torch.stack([full_t, stalled | (beta >= 1.0)]
                                     ).tolist()
            run.host_reads += 1
            if stop:
                break
            u = torch.rand((), generator=gen, dtype=torch.float32,
                           device=dev)
            s = stage_on(sweeps, x, lp_t, lp_p, beta, full, u,
                         *_mh_draws(gen, n_mh_steps, x))
            x, lp_t, lp_p, beta = s.x, s.lp_t, s.lp_p, s.beta
            stalled = s.stalled
            log_z = log_z + s.log_z_increment
            betas_buf[j] = beta
            ess_buf[j] = s.ess
            j += 1
            if full:  # beta is 1: no read needed to stop
                break
        return x, beta, log_z, j, betas_buf, ess_buf

    run.stage = stage
    run.host_reads = 0
    return run


def smc_log_z(
    target,
    n_particles: int,
    dim: int,
    *,
    n_mh_steps: int = 5,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    target_ess: float = 0.8,
    max_stages: int = 256,
    seed: Optional[int] = None,
    key=None,
    device="cuda",
) -> SMCResult:
    """Estimate ``log Z`` of an unnormalized ``target`` by adaptive SMC.

    Args:
        target: the unnormalized target (``batch_logp`` is used).
        n_particles: population size N.
        dim: target dimension D.
        n_mh_steps: tempered-MH rejuvenation sweeps per stage.
        proposal_std: MH random-walk scale (scalar or per-dimension [D]).
        prior_mean / prior_std: the normalized Gaussian prior (as in
            :func:`~mini_mcmc_torch.ops.ais.ais_log_z`).
        target_ess: ESS fraction in (0, 1) each adaptive increment aims
            for; smaller is greedier (fewer, larger steps). ``stage_ess``
            cannot see MH mixing failure: if estimates drift across seeds,
            raise ``n_mh_steps`` / ``target_ess``, not just N.
        max_stages: hard cap on stages; reaching it raises, since a
            truncated anneal biases log Z.
        seed / key: the randomness (at most one; ``seed`` defaults to 0):
            ``key`` a ``torch.Generator`` on ``device`` or a
            :class:`~mini_mcmc_torch.runner.StepKey`.
        device: where the particles live (``"cuda"`` by default; raises
            without a GPU).

    For repeated runs of one configuration build the loop once with
    :func:`make_smc_run`.
    """
    if n_particles < 2:
        raise ValueError(f"n_particles must be >= 2, got {n_particles}")
    if n_particles > _STRATA_CAP:
        raise ValueError(
            f"n_particles={n_particles} exceeds the float32 resampling-"
            f"strata resolution (2^24 = {_STRATA_CAP})"
        )
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    device = resolve_device(device)
    gen = _resolve_key(seed, key, device)
    mean, std, _ = _gaussian_prior(prior_mean, prior_std, dim, device)
    run = make_smc_run(
        target, n_mh_steps=n_mh_steps, proposal_std=proposal_std,
        prior_mean=prior_mean, prior_std=prior_std,
        target_ess=target_ess, max_stages=max_stages,
    )
    x0 = mean + std * torch.randn((n_particles, dim), generator=gen,
                                  dtype=torch.float32, device=device)
    x, beta, log_z, n_stages, betas_buf, ess_buf = run(x0, gen)
    beta = float(beta)
    if beta < 1.0:
        if n_stages < max_stages:
            raise RuntimeError(
                f"SMC anneal stalled at beta={beta:.6g}: one float32 ulp of "
                "beta already drops the incremental ESS below target_ess "
                "(the target's logp spread is too large for a float32 "
                "anneal); rescale the problem or lower target_ess"
            )
        raise RuntimeError(
            f"SMC hit max_stages={max_stages} at beta={beta:.6f} < 1: the "
            "anneal is truncated and log_z would be biased; raise "
            "max_stages, or LOWER target_ess for greedier steps"
        )
    return SMCResult(
        log_z=log_z,
        positions=x,
        n_stages=n_stages,
        betas=betas_buf[:n_stages],
        stage_ess=ess_buf[:n_stages],
    )
