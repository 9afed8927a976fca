"""Streaming and final MCMC diagnostics (counterpart of
``mini_mcmc_tpu/stats.py``).

- The streaming tracker (``TrackerState``, ``tracker_init``,
  ``tracker_update``; the reference's ``MultiChainTracker``,
  ``stats.rs:189-307``) folds every step's ``[C, P]`` positions into
  running moments and an acceptance EWMA on the positions' device; the
  runners thread it through a run (``runner.py``). ``tracker_update_rows``
  folds a block's ``[K, C, P]`` rows in one pass, where the JAX package
  calls ``tracker_update`` K times.
- ``collect_rhat`` and ``tracker_rhat``: the live R-hat from streaming
  moments (``stats.rs:150-178``, ``:282-306``).
- ``split_rhat_mean_ess`` (``stats.rs:416-546``): split chains,
  within/between variances, Stan-style rho_t with Geyer's initial-monotone
  pairwise sums, the brute-force autocovariance for ``n <= 100`` and FFT
  beyond. The autocovariances act on the time axis ``-2`` of
  ``[..., n, P]`` tensors, so a batch of chains needs no ``vmap``.
- ``BasicStats``/``basic_stats`` and ``RunStats``/``run_stats``
  (``stats.rs:309-392``).

The formulas replicate the reference in structure, quirks included, as the
JAX package does. Do not "fix" them: they are parity targets.

- The final split R-hat is ``sqrt(W / var)`` (``stats.rs:425-427``), the
  inverse of the tracker's live ``sqrt(var / W)``; ``n' = n // 2`` with
  the middle draw dropped for odd n.
- The acceptance EWMA (alpha = 0.01) of the "state changed" indicator is
  folded in order across the chains within a step (``stats.rs:250-255``);
  each chain's own EWMA seeds its first step from coordinate 0 alone
  (``stats.rs:110-116``).
- ``collect_rhat``'s between-chain variance divides by ``C * P - 1``
  (``stats.rs:173``).
- ``basic_stats`` reports ``data[n // 2]`` of a descending sort as the
  median, and a ddof=1 std (``stats.rs:310-336``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from .parallel.collectives import (
    all_gather,
    all_reduce,
    gather_chains,
    gather_state,
    split,
)
from .utils.init import resolve_device


def split_cube(sample, time_major: bool = False):
    """``(local, chains, state)``: a cube sharded on its chain axis (a
    DTensor from a sharded sampler) as this rank's block, its
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup` and, when
    its last axis (D) is split over a ``"state"`` axis, its
    :class:`~mini_mcmc_torch.parallel.collectives.StateGroup`;
    ``(sample, None, None)`` for any other cube."""
    from .parallel.mesh import local_state

    local, layout = local_state(sample)
    if layout is None:
        return sample, None, None
    if layout.axes != (1 if time_major else 0):
        raise ValueError(
            f"a {'time' if time_major else 'chain'}-major cube is sharded "
            f"on axis {1 if time_major else 0}; this one on "
            f"{layout.axes}")
    return local, layout.chains, layout.state


def full_cube(sample, time_major: bool = False):
    """A cube sharded on its chain axis gathered whole on every rank (one
    all-gather, and one more over the ``"state"`` axis when D is split);
    any other cube as it is."""
    local, chains, state = split_cube(sample, time_major)
    return gather_state(gather_chains(local, chains, 1 if time_major else 0),
                        state)


ALPHA = 0.01  # EWMA coefficient of the acceptance tracking (stats.rs:13)


# ---------------------------------------------------------------------------
# Streaming tracker, threaded through the runners
# ---------------------------------------------------------------------------


class TrackerState(NamedTuple):
    """Running moments of every chain (``MultiChainTracker``,
    ``stats.rs:189-197``), ``[C, P]`` float32 tensors on the positions'
    device, plus each chain's own acceptance EWMA (the per-chain
    ``ChainTracker`` surface, ``stats.rs:26-141``).

    ``n`` is a host int: the number of steps is known on the host, so no
    update syncs the device to read it (a 0-d int32 array in the JAX
    package).
    """

    n: int  # steps seen
    p_accept: torch.Tensor  # 0-d float32 EWMA acceptance
    last_state: torch.Tensor  # [C, P]
    mean: torch.Tensor  # [C, P]
    mean_sq: torch.Tensor  # [C, P]
    #: [C] per-chain EWMA acceptance; -1 before the first step
    p_accept_chains: torch.Tensor


def tracker_init(n_chains: int, n_params: int, initial_state=None, *,
                 device="cuda") -> TrackerState:
    """A fresh tracker on ``device`` (``"cuda"`` by default, raising
    without a GPU), or on ``initial_state``'s device when it is a tensor;
    ``initial_state`` seeds ``last_state`` (zeros in the reference's
    ``MultiChainTracker``, ``stats.rs:208-219``)."""
    if isinstance(initial_state, torch.Tensor):
        device = initial_state.device
    device = resolve_device(device)
    shape = (n_chains, n_params)
    f32 = dict(dtype=torch.float32, device=device)
    last = (torch.zeros(shape, **f32) if initial_state is None
            else torch.as_tensor(initial_state).to(**f32).reshape(shape))
    return TrackerState(
        n=0,
        p_accept=torch.zeros((), **f32),
        last_state=last,
        mean=torch.zeros(shape, **f32),
        mean_sq=torch.zeros(shape, **f32),
        p_accept_chains=torch.full((n_chains,), -1.0, **f32),
    )


@functools.lru_cache(maxsize=16)
def _decay(n: int, device: torch.device) -> torch.Tensor:
    """``(1 - ALPHA) ** [n-1, ..., 1, 0]`` in float32, as the JAX package
    computes its powers (``stats.py:106``): the weights of an EWMA folded
    over n values in order. They underflow to 0 past ~10,000 terms in both
    packages."""
    exps = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(1.0 - ALPHA, device=device), exps)


def _as_rows(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """float32, a trailing parameter axis added to ``[..., C]`` input."""
    positions = positions.to(torch.float32)
    return positions[..., None] if positions.dim() == dim - 1 else positions


def _ewma_weights(k: int, n_chains: int, chains, device) -> tuple:
    """``(decay, n)``: the EWMA weights of the ``[K, C_local]`` values a
    block folds, flattened, and the global chain count. Value ``(k, c)``
    is global value ``k C + chain0 + c`` of the K*C in order; a shard
    folds its own at their global weights, and the global EWMA is the sum
    of every shard's (:func:`tracker_stats` reduces it)."""
    if chains is None:
        return _decay(k * n_chains, device), n_chains
    n = chains.n_chains
    w = _decay(k * n, device).view(k, n)
    return w[:, chains.chain0:chains.chain0 + n_chains].reshape(-1), n


def tracker_update(tracker: TrackerState, positions: torch.Tensor,
                   chains=None) -> TrackerState:
    """One streaming update with a step's ``[C, P]`` positions
    (``stats.rs:228-259``, ``mini_mcmc_tpu/stats.py:85-126``).

    The reference folds the acceptance EWMA over the chain rows in order;
    the closed form weighs row i by ``alpha * (1-alpha)^(C-1-i)`` and the
    old value by ``(1-alpha)^C``. Under ``chains`` (a sharded run's
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`) the rows are
    the shard's, weighed at their global places, and ``p_accept`` holds
    the shard's share of the global EWMA (every share starts at 0).
    """
    x = _as_rows(positions, 2)
    decay, n_chains = _ewma_weights(1, x.shape[0], chains, x.device)
    n = float(tracker.n + 1)
    last = tracker.last_state
    # the JAX package's rounding: no fused multiply-add (a row's rounding
    # stays in the running moments)
    mean = (tracker.mean * (n - 1.0) + x) / n
    mean_sq = (tracker.mean_sq * (n - 1.0) + x * x) / n
    accepted = (x != last).any(dim=1).to(torch.float32)
    p_accept = (tracker.p_accept * (1.0 - ALPHA) ** n_chains).add_(
        torch.dot(decay, accepted), alpha=ALPHA)
    # each chain's EWMA, the ChainTracker first-step rule
    # (stats.rs:110-116): its seed compares coordinate 0 only
    pac = tracker.p_accept_chains
    base = torch.where(pac < 0.0, x[:, 0] != last[:, 0], pac)
    return TrackerState(
        n=tracker.n + 1,
        p_accept=p_accept,
        last_state=x,
        mean=mean,
        mean_sq=mean_sq,
        p_accept_chains=torch.add(base * (1.0 - ALPHA), accepted,
                                  alpha=ALPHA),
    )


def tracker_update_rows(tracker: TrackerState, rows: torch.Tensor,
                        chains=None) -> TrackerState:
    """K updates at once with a block's ``[K, C, P]`` rows, row 0 first:
    the result of K calls of :func:`tracker_update` (the JAX package makes
    those K calls, ``mini_mcmc_tpu/runner.py:149-154``), up to float32
    rounding, in one vectorised pass.

    The moments are a weighted block sum; row k "changed" where it differs
    from row k-1 (row 0 from ``last_state``); the global EWMA is its
    closed form over the K*C (step, chain) values in order, and each
    chain's over its K values; the first-step rule reaches row 0 only.
    ``chains`` as :func:`tracker_update`'s.
    """
    x = _as_rows(rows, 3)
    k = x.shape[0]
    decay, n_chains = _ewma_weights(k, x.shape[1], chains, x.device)
    n0 = float(tracker.n)
    n = n0 + k
    last = tracker.last_state
    mean = torch.add(x.sum(dim=0), tracker.mean, alpha=n0).div_(n)
    mean_sq = torch.add((x * x).sum(dim=0), tracker.mean_sq,
                        alpha=n0).div_(n)
    accepted = (x != torch.cat((last[None], x[:-1]))).any(dim=2).to(
        torch.float32)  # [K, C]
    # value j of the K*C in order weighs (1-alpha)^(K*C-1-j)
    p_accept = (tracker.p_accept * (1.0 - ALPHA) ** (n_chains * k)).add_(
        torch.dot(decay, accepted.reshape(-1)), alpha=ALPHA)
    pac = tracker.p_accept_chains
    base = torch.where(pac < 0.0, x[0, :, 0] != last[:, 0], pac)
    return TrackerState(
        n=tracker.n + k,
        p_accept=p_accept,
        last_state=x[-1].clone(),  # the rows may be a reused buffer
        mean=mean,
        mean_sq=mean_sq,
        p_accept_chains=torch.addmv(base, accepted.T, _decay(k, x.device),
                                    beta=(1.0 - ALPHA) ** k, alpha=ALPHA),
    )


class ChainStats(NamedTuple):
    """Snapshot of streaming statistics (``stats.rs:43-48``)."""

    n: int
    p_accept: torch.Tensor
    mean: torch.Tensor  # [P] or [C, P]
    sm2: torch.Tensor  # [P] or [C, P]


def _sm2(tracker: TrackerState) -> torch.Tensor:
    n = float(tracker.n)
    return (tracker.mean_sq - tracker.mean ** 2) * n / (n - 1.0)


def _p_accept(tracker: TrackerState, chains) -> torch.Tensor:
    """The global acceptance EWMA: the sum of every shard's share."""
    if chains is None:
        return tracker.p_accept
    return all_reduce(tracker.p_accept.clone(), chains.group)


def tracker_stats(tracker: TrackerState, chains=None) -> ChainStats:
    """Bias-corrected snapshot: ``sm2 = (mean_sq - mean^2) * n/(n-1)``
    (``stats.rs:132-140``, ``:300``). A sharded run's tracker (``chains``)
    gives the global ``p_accept`` (one scalar all-reduce) beside its own
    chains' moments."""
    return ChainStats(n=tracker.n, p_accept=_p_accept(tracker, chains),
                      mean=tracker.mean, sm2=_sm2(tracker))


def tracker_rhat(tracker: TrackerState, chains=None,
                 state=None) -> torch.Tensor:
    """Live R-hat per parameter from the streaming moments
    (``MultiChainTracker::rhat``, ``stats.rs:282-306``): ``sqrt(var /
    W)``, the inverse of the final split R-hat. A sharded run's tracker
    (``chains``) gathers every shard's ``[C, P]`` moments first (one
    all-gather), so the value is the unsharded run's; a state-split run's
    (``state``) gathers its D-slices' values (one more)."""
    moments = gather_chains(torch.stack([tracker.mean, _sm2(tracker)],
                                        dim=1), chains)
    means, sm2 = moments[:, 0], moments[:, 1]
    n_chains = means.shape[0]
    n = float(tracker.n)
    mean_chain = torch.mean(means, dim=0)
    fac = n / (n_chains - 1.0)
    between = torch.sum((means - mean_chain[None, :]) ** 2, dim=0) * fac
    within = torch.mean(sm2, dim=0)
    var = within * ((n - 1.0) / n) + between * (1.0 / n)
    return gather_state(torch.sqrt(var / within), state)


def tracker_max_rhat(tracker: TrackerState, chains=None,
                     state=None) -> torch.Tensor:
    return torch.max(tracker_rhat(tracker, chains, state))


class ChainTracker:
    """Single-chain streaming tracker (the reference's ``ChainTracker``,
    ``stats.rs:26-141``): a stateful wrapper over a one-chain
    :class:`TrackerState` on ``device``.

    Example:
        >>> t = ChainTracker(2, [0.0, 0.0], device="cpu")
        >>> t.step([1.0, 2.0])
        >>> t.stats().mean.tolist()
        [1.0, 2.0]
    """

    def __init__(self, n_params: int, initial_state=None, *,
                 device="cuda"):
        device = resolve_device(device)
        init = (None if initial_state is None else torch.as_tensor(
            initial_state, dtype=torch.float32).reshape(1, n_params).to(
                device))
        self._state = tracker_init(1, n_params, init, device=device)

    def step(self, x) -> None:
        self._state = tracker_update(self._state, torch.as_tensor(
            x, dtype=torch.float32,
            device=self._state.mean.device).reshape(1, -1))

    def stats(self) -> ChainStats:
        cs = tracker_stats(self._state)
        return ChainStats(n=cs.n, p_accept=self._state.p_accept_chains[0],
                          mean=cs.mean[0], sm2=cs.sm2[0])


def _withinvar_from_cs(means, sm2s, ns):
    """Within-chain and pooled variance from live per-chain stats
    (``withinvar_from_cs``, ``stats.rs:155-178``), with the reference's
    ``diffs.len() - 1`` (= C*P - 1) between-chain divisor
    (``stats.rs:173``)."""
    means = torch.as_tensor(means).to(torch.float32)
    sm2s = torch.as_tensor(sm2s).to(torch.float32)
    within = torch.mean(sm2s, dim=0)
    diffs = means - torch.mean(means, dim=0)[None, :]
    between = torch.sum(diffs ** 2, dim=0) / (diffs.numel() - 1)
    n = torch.mean(torch.as_tensor(ns).to(torch.float32).to(means.device))
    var = between + within * ((n - 1.0) / n)
    return within, var


def collect_rhat(means, sm2s, ns) -> torch.Tensor:
    """Live R-hat from per-chain ``ChainStats`` (``stats.rs:150-178``):
    ``means`` and ``sm2s`` ``[C, P]``, ``ns`` ``[C]``."""
    within, var = _withinvar_from_cs(means, sm2s, ns)
    return torch.sqrt(var / within)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def autocov_fft(sample: torch.Tensor) -> torch.Tensor:
    """FFT autocovariance along axis -2 of ``[..., n, d]`` -> same shape.

    Zero-pads to the next power of two >= 2n-1 (stats.rs:580-584); biased
    normalization ``1/n``.
    """
    sample = sample.to(torch.float32)
    n = sample.shape[-2]
    n_padded = _next_pow2(max(2 * n - 1, 1))
    x = sample - torch.mean(sample, dim=-2, keepdim=True)
    f = torch.fft.rfft(x, n=n_padded, dim=-2)
    acov = torch.fft.irfft(f.abs() ** 2, n=n_padded, dim=-2)[..., :n, :]
    return acov / n


def autocov_bf(sample: torch.Tensor) -> torch.Tensor:
    """Brute-force autocovariance (stats.rs:632-654), used for n <= 100:
    ``out[lag, d] = sum_t x[t, d] * x[t+lag, d] / n`` on mean-subtracted
    x, along axis -2 of ``[..., n, d]``."""
    sample = sample.to(torch.float32)
    n = sample.shape[-2]
    x = sample - torch.mean(sample, dim=-2, keepdim=True)
    if n == 0:
        return x  # no lags: [..., 0, d]
    rows = [torch.sum(x[..., : n - lag, :] * x[..., lag:, :], dim=-2) / n
            for lag in range(n)]
    return torch.stack(rows, dim=-2)


def autocov(sample: torch.Tensor) -> torch.Tensor:
    """Dispatch: brute force for n <= 100, FFT beyond (stats.rs:548-554)."""
    if sample.shape[-2] <= 100:
        return autocov_bf(sample)
    return autocov_fft(sample)


def _splitcat(sample: torch.Tensor) -> torch.Tensor:
    """(C, n, P) -> (2C, n//2, P): first and last halves of each chain
    (stats.rs:396-402; the middle element is dropped when n is odd)."""
    n = sample.shape[1]
    half = n // 2
    return torch.cat([sample[:, :half], sample[:, n - half:]], dim=0)


def _bwv_from_moments(chain_means, squares, nf: float):
    """W and pooled var from per-split-chain means and biased variances
    ``[2C, P]`` (stats.rs:429-477), shared by both layouts."""
    c = chain_means.shape[0]
    overall_mean = torch.mean(chain_means, dim=0)
    diff = chain_means - overall_mean[None, :]
    b = torch.sum(diff**2, dim=0) * (nf / (c - 1.0))
    w = torch.mean(squares, dim=0)
    v = ((nf - 1.0) / nf) * w + b / nf if nf > 0 else w * float("nan")
    return w, v


def _split_moments(chain_means, squares, chains):
    """``[2C, P]`` split-chain means and biased variances over every
    shard, from a shard's ``[2 C_local, P]`` (first halves, then last
    halves): one all-gather, rows in the unsharded order."""
    if chains is None:
        return chain_means, squares
    c, p = chain_means.shape[0] // 2, chain_means.shape[1]
    both = torch.stack([chain_means, squares]).view(2, 2, c, p)
    both = all_gather(both, chains.group, axis=2)
    return both[0].reshape(-1, p), both[1].reshape(-1, p)


def _withinvar(splitted: torch.Tensor, chains=None):
    """W and pooled var per parameter of a ``[2C, n', P]`` split cube
    (a shard's, under ``chains``)."""
    chain_means = torch.mean(splitted, dim=1)
    squares = torch.mean((splitted - chain_means[:, None, :]) ** 2, dim=1)
    return _bwv_from_moments(*_split_moments(chain_means, squares, chains),
                             float(splitted.shape[1]))


def _geyer_tau(rho: torch.Tensor) -> torch.Tensor:
    """Geyer initial-monotone pairwise sum (stats.rs:518-543) of ``[n, P]``
    autocorrelations: pair sums ``rho[2t] + rho[2t+1]``, their running
    minimum while they stay positive, ``tau = -1 + 2 * sum``."""
    n_pairs = rho.shape[0] // 2
    if n_pairs == 0:
        return torch.full(rho.shape[1:], -1.0, dtype=rho.dtype,
                          device=rho.device)
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, -1).sum(dim=1)
    valid = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    running_min = torch.cummin(pairs, dim=0).values
    return -1.0 + 2.0 * torch.sum(valid * running_min, dim=0)


#: chains per autocovariance batch: bounds the FFT scratch (complex spectra
#: are ~4x the input); only the chain-mean of the autocovariances is needed
_AUTOCOV_CHUNK = 8192


def _chain_sum(acc: torch.Tensor, chains) -> torch.Tensor:
    """A shard's sum over its chains summed over every shard."""
    return acc if chains is None else all_reduce(acc, chains.group)


def _ess(splitted: torch.Tensor, within, var, chains=None) -> torch.Tensor:
    """ESS per parameter (stats.rs:496-546) of a ``[2C, n', P]`` cube (a
    shard's, under ``chains``: its autocovariances summed over every
    shard, one all-reduce)."""
    n_chains, n_steps = splitted.shape[0], splitted.shape[1]
    acc = torch.zeros(splitted.shape[1:], dtype=torch.float32,
                      device=splitted.device)
    for i in range(0, n_chains, _AUTOCOV_CHUNK):
        acc = acc + torch.sum(autocov(splitted[i:i + _AUTOCOV_CHUNK]), dim=0)
    if chains is not None:
        acc = _chain_sum(acc, chains)
        n_chains = 2 * chains.n_chains
    rho = 1.0 - (within[None, :] - acc / n_chains) / var[None, :]
    return (n_chains * n_steps) / _geyer_tau(rho)


def _tm_moments(sample: torch.Tensor, chains=None):
    """Split moments of a time-major ``[N, C, P]`` cube -> (rhat, W, var),
    read from the cube in place (half-cube views, no split copy)."""
    n = sample.shape[0]
    half = n // 2
    first = sample[:half]
    last = sample[n - half:]
    cm_first = torch.mean(first, dim=0)
    cm_last = torch.mean(last, dim=0)
    chain_means = torch.cat([cm_first, cm_last], dim=0)
    squares = torch.cat([
        torch.mean((first - cm_first[None]) ** 2, dim=0),
        torch.mean((last - cm_last[None]) ** 2, dim=0),
    ], dim=0)
    within, var = _bwv_from_moments(
        *_split_moments(chain_means, squares, chains), float(half))
    return torch.sqrt(within / var), within, var


def _split_rhat_mean_ess_tm(sample: torch.Tensor, chains=None):
    """Time-major ``[N, C, P]`` variant of :func:`split_rhat_mean_ess`: the
    autocovariance slices one chain block of the cube at a time, so the
    peak is one cube plus a chunk (no ``_splitcat`` copy)."""
    n = sample.shape[0]
    half = n // 2
    rhat, within, var = _tm_moments(sample, chains)
    n_chains_total = 2 * (sample.shape[1] if chains is None
                          else chains.n_chains)
    acc = torch.zeros((half,) + tuple(sample.shape[2:]), dtype=torch.float32,
                      device=sample.device)
    step = max(1, _AUTOCOV_CHUNK // 2)
    for i in range(0, sample.shape[1], step):
        for lo in (0, n - half):
            blk = sample[lo:lo + half, i:i + step].transpose(0, 1)
            acc = acc + torch.sum(autocov(blk), dim=0)
    acc = _chain_sum(acc, chains)
    rho = 1.0 - (within[None, :] - acc / n_chains_total) / var[None, :]
    ess = (n_chains_total * half) / _geyer_tau(rho)
    return rhat, ess


def split_rhat_mean_ess(sample: torch.Tensor, *, time_major: bool = False):
    """Split R-hat and ESS per parameter (stats.rs:416-423).

    Args:
        sample: ``[chains, observations, parameters]``, or
            ``[observations, chains, parameters]`` with ``time_major=True``.

    Returns:
        ``(rhat [P], ess [P])``. The reference's split R-hat is
        ``sqrt(W / var)`` (stats.rs:425-427), preserved here.

    A cube sharded on its chain axis (a sharded sampler's, a DTensor)
    stays where it is: each rank reduces its own chains, and the split
    means and variances (one all-gather of ``[2, 2C, P]``) and the summed
    autocovariances (one all-reduce of ``[n', P]``) cross ranks. Every
    rank gets the unsharded cube's values, up to the order of that sum. A
    cube whose D is split over a ``"state"`` axis gives each rank its
    D-slice's values, then gathers every slice's (one all-gather of
    ``[2, P]``).
    """
    sample, chains, state = split_cube(sample, time_major)
    sample = torch.as_tensor(sample).to(torch.float32)
    if time_major:
        rhat, ess = _split_rhat_mean_ess_tm(sample, chains)
    else:
        splitted = _splitcat(sample)
        within, var = _withinvar(splitted, chains)
        rhat = torch.sqrt(within / var)
        ess = _ess(splitted, within, var, chains)
    if split(state):  # the D-slices' parameters, gathered in one call
        rhat, ess = gather_state(torch.stack([rhat, ess]), state)
    return rhat, ess


def ess_from_chainstats(sample, means, sm2s, ns) -> torch.Tensor:
    """ESS of a ``[C, N, P]`` cube from live streaming stats, without
    splitting (``stats.rs:668-671``)."""
    sample = torch.as_tensor(sample).to(torch.float32)
    within, var = _withinvar_from_cs(means, sm2s, ns)
    return _ess(sample, within.to(sample.device), var.to(sample.device))


# ---------------------------------------------------------------------------
# Run summaries (stats.rs:309-392)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasicStats:
    """min/median/max/mean/std summary (``stats.rs:373-392``)."""

    name: str
    min: float
    median: float
    max: float
    mean: float
    std: float

    def __str__(self) -> str:
        return (
            f"{self.name} in [{self.min:.2f}, {self.max:.2f}], "
            f"median: {self.median:.2f}, mean: {self.mean:.2f} "
            f"± {self.std:.2f}"
        )


def _desc_nan_equal(a: float, b: float) -> int:
    """The reference comparator ``b.partial_cmp(a)`` falling back to
    ``Ordering::Equal`` for NaN (``stats.rs:312-316``)."""
    if math.isnan(a) or math.isnan(b):
        return 0
    return (a < b) - (a > b)


def basic_stats(name: str, data) -> BasicStats:
    """Summary with the reference's descending-sort median index
    ``data[n // 2]`` and ddof=1 std (``stats.rs:310-336``).

    The host sort keeps the reference's comparator, NaN equal to
    everything (a NaN stays in place instead of becoming the max); with
    several interior NaNs the order is best effort, as in the JAX package.
    The mean and std are summed in float64 and rounded to float32: the
    float32 values the JAX package reports, up to the last bit, which
    follows XLA's summation order.
    """
    data = torch.as_tensor(data).to(torch.float32).reshape(-1)
    n = data.shape[0]
    values = data.tolist()  # the one host read
    desc = sorted(values, key=functools.cmp_to_key(_desc_nan_equal))
    host = torch.tensor(values, dtype=torch.float64)
    mean = float(torch.mean(host).to(torch.float32))
    std = (float(torch.std(host, correction=1).to(torch.float32))
           if n > 1 else 0.0)
    return BasicStats(name=name, min=desc[-1], median=desc[n // 2],
                      max=desc[0], mean=mean, std=std)


@dataclasses.dataclass
class RunStats:
    """Final run diagnostics: ESS and split R-hat summaries
    (``stats.rs:339-371``)."""

    ess: BasicStats
    rhat: BasicStats

    def __str__(self) -> str:
        return f"{self.ess}\n{self.rhat}"

    @classmethod
    def from_sample(cls, sample, *, time_major: bool = False) -> "RunStats":
        rhat, ess = split_rhat_mean_ess(sample, time_major=time_major)
        return cls(ess=basic_stats("ESS", ess),
                   rhat=basic_stats("Split R-hat", rhat))


def run_stats(sample, *, time_major: bool = False) -> RunStats:
    """Final diagnostics of a ``[C, N, P]`` cube (``[N, C, P]`` with
    ``time_major=True``)."""
    return RunStats.from_sample(sample, time_major=time_major)
