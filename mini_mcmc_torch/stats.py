"""Split R-hat and ESS (counterpart of ``mini_mcmc_tpu/stats.py:232-457``).

The formulas replicate the reference (``stats.rs:394-654``) in structure,
quirks included, as the JAX package does: the inverted split R-hat
``sqrt(W / var)``, the ``n' = n // 2`` split with the middle draw dropped
for odd n, and the brute-force autocovariance for ``n <= 100`` with FFT
beyond. Do not "fix" them: they are parity targets.

The autocovariances act on the time axis ``-2`` of ``[..., n, P]`` tensors,
so a batch of chains needs no ``vmap``.
"""

from __future__ import annotations

import torch


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


def _withinvar(splitted: torch.Tensor):
    """W and pooled var per parameter of a ``[2C, n', P]`` split cube."""
    chain_means = torch.mean(splitted, dim=1)
    squares = torch.mean((splitted - chain_means[:, None, :]) ** 2, dim=1)
    return _bwv_from_moments(chain_means, squares, float(splitted.shape[1]))


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


def _ess(splitted: torch.Tensor, within, var) -> torch.Tensor:
    """ESS per parameter (stats.rs:496-546) of a ``[2C, n', P]`` cube."""
    n_chains, n_steps = splitted.shape[0], splitted.shape[1]
    acc = torch.zeros(splitted.shape[1:], dtype=torch.float32,
                      device=splitted.device)
    for i in range(0, n_chains, _AUTOCOV_CHUNK):
        acc = acc + torch.sum(autocov(splitted[i:i + _AUTOCOV_CHUNK]), dim=0)
    rho = 1.0 - (within[None, :] - acc / n_chains) / var[None, :]
    return (n_chains * n_steps) / _geyer_tau(rho)


def _tm_moments(sample: torch.Tensor):
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
    within, var = _bwv_from_moments(chain_means, squares, float(half))
    return torch.sqrt(within / var), within, var


def _split_rhat_mean_ess_tm(sample: torch.Tensor):
    """Time-major ``[N, C, P]`` variant of :func:`split_rhat_mean_ess`: the
    autocovariance slices one chain block of the cube at a time, so the
    peak is one cube plus a chunk (no ``_splitcat`` copy)."""
    n = sample.shape[0]
    half = n // 2
    rhat, within, var = _tm_moments(sample)
    n_chains_total = 2 * sample.shape[1]
    acc = torch.zeros((half,) + tuple(sample.shape[2:]), dtype=torch.float32,
                      device=sample.device)
    step = max(1, _AUTOCOV_CHUNK // 2)
    for i in range(0, sample.shape[1], step):
        for lo in (0, n - half):
            blk = sample[lo:lo + half, i:i + step].transpose(0, 1)
            acc = acc + torch.sum(autocov(blk), dim=0)
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
    """
    sample = torch.as_tensor(sample).to(torch.float32)
    if time_major:
        return _split_rhat_mean_ess_tm(sample)
    splitted = _splitcat(sample)
    within, var = _withinvar(splitted)
    return torch.sqrt(within / var), _ess(splitted, within, var)
