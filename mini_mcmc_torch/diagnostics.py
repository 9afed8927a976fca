"""Rank-normalized convergence diagnostics (Vehtari et al. 2021) and the
posterior summary table.

Counterpart of ``mini_mcmc_tpu/diagnostics.py``: the rank-normalized split
R-hat (bulk and folded, STANDARD orientation ``sqrt(var / W)``), bulk ESS
and tail ESS, built on a double ``argsort`` and ``torch.special.ndtri``;
and :func:`summary`, mean, sd, Monte-Carlo standard errors, quantiles and
those diagnostics per parameter. Quantiles come from one sort per
parameter (:func:`_quantile`, ``jnp.quantile``'s linear interpolation), at
any number of draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .stats import _ess, _splitcat, _withinvar, full_cube


def _quantile(pm: torch.Tensor, q) -> torch.Tensor:
    """Quantiles of each row of ``[P, S]`` draws, ``jnp.quantile(pm, q,
    axis=1)`` with its default ``linear`` interpolation: ``[P]`` for a
    scalar ``q``, ``[Q, P]`` for a sequence.

    One sort per row, then the two neighbours of ``q (S - 1)`` weighed in
    float64, as ``jnp.quantile`` does under x64 (its float32 form rounds
    ``S - 1`` above 2**24 and may pick a neighbour off by one). A row
    holding a NaN gives NaN, as there. Unlike ``torch.quantile``, which
    raises above 2**24 draws, it takes any number.
    """
    scalar = not isinstance(q, (tuple, list))
    levels = [float(q)] if scalar else [float(v) for v in q]
    s = pm.shape[1]
    srt = torch.sort(pm, dim=1).values  # NaNs last
    pos = [v * (s - 1) for v in levels]
    lo = [min(max(math.floor(x), 0), s - 1) for x in pos]
    hi = [min(max(math.ceil(x), 0), s - 1) for x in pos]
    vals = srt.index_select(1, torch.tensor(lo + hi, device=pm.device))
    vals = vals.to(torch.float64)
    w_hi = torch.tensor([x - math.floor(x) for x in pos],
                        dtype=torch.float64, device=pm.device)
    n_q = len(levels)
    out = vals[:, :n_q] * (1.0 - w_hi) + vals[:, n_q:] * w_hi  # [P, Q]
    out = torch.where(torch.isnan(srt[:, -1:]), math.nan, out)
    out = out.T.to(pm.dtype)
    return out[0] if scalar else out


def _rank_normalize_pm(flat_pm: torch.Tensor) -> torch.Tensor:
    """Rank-normalize ``[P, S]`` draws to z-scores: ordinal ranks by double
    argsort, then ``z = Phi^-1((r + 1 - 3/8) / (S + 1/4))`` (eq. 14).

    ``u`` is float64: float32 ranks round above 2**24 draws, and the top
    rank's ``u`` then rounds to 1, an infinite z and a NaN R-hat (as in
    the JAX package, whose ranks are float32)."""
    s = flat_pm.shape[1]
    # stable, as jnp.argsort: folding around a median that is the midpoint
    # of two draws makes those two draws tie exactly
    order = torch.argsort(flat_pm, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)  # 0-based
    u = (ranks.to(torch.float64) + (1.0 - 0.375)) / (s + 0.25)
    return torch.special.ndtri(u).to(torch.float32)


def _rank_normalize_cube(sample: torch.Tensor) -> torch.Tensor:
    """Rank-normalize a ``[C, N, P]`` cube over all draws per parameter."""
    c, n, p = sample.shape
    pm = sample.permute(2, 0, 1).reshape(p, c * n)
    return _rank_normalize_pm(pm).reshape(p, c, n).permute(1, 2, 0)


def _standard_split_rhat(splitted: torch.Tensor) -> torch.Tensor:
    within, var = _withinvar(splitted)
    return torch.sqrt(var / within)


@dataclasses.dataclass
class ModernDiagnostics:
    """Per-parameter rank-normalized diagnostics (``[P]`` tensors).

    ``rhat`` is ``max(rhat_bulk, rhat_folded)``, the quantity Stan reports;
    flag parameters above ~1.01.
    """

    rhat: torch.Tensor
    rhat_bulk: torch.Tensor
    rhat_folded: torch.Tensor
    ess_bulk: torch.Tensor
    ess_tail: torch.Tensor


def rank_normalized_diagnostics(sample: torch.Tensor, *,
                                time_major: bool = False) -> ModernDiagnostics:
    """Rank-normalized split R-hat, bulk ESS and tail ESS per parameter.

    Args:
        sample: ``[chains, observations, parameters]`` cube, or
            ``[observations, chains, parameters]`` with ``time_major=True``.
            A cube sharded on its chain axis (a DTensor) is gathered whole
            on every rank first (one all-gather): the ranks and quantiles
            run over all draws.
    """
    sample = torch.as_tensor(full_cube(sample, time_major)).to(torch.float32)
    if sample.dim() != 3:
        raise ValueError(
            f"sample must be a 3-D cube; got shape {tuple(sample.shape)}"
        )
    if time_major:
        sample = sample.transpose(0, 1)
    c, n, p = sample.shape
    pm = sample.permute(2, 0, 1).reshape(p, c * n)

    # bulk: rank-normalize all draws, then standard split R-hat + ESS
    splitted = _splitcat(_rank_normalize_cube(sample))
    within, var = _withinvar(splitted)
    rhat_bulk = torch.sqrt(var / within)
    ess_bulk = _ess(splitted, within, var)

    # folded: |x - median|, sensitive to chains that differ in scale
    median, q05, q95 = _quantile(pm, (0.5, 0.05, 0.95))
    folded = torch.abs(sample - median[None, None, :])
    rhat_folded = _standard_split_rhat(_splitcat(_rank_normalize_cube(folded)))

    # tail: ESS of the raw 5% / 95% exceedance indicators (no rank transform)
    ess_tails = []
    for ind in (sample <= q05[None, None, :], sample >= q95[None, None, :]):
        split_ind = _splitcat(ind.to(torch.float32))
        w, v = _withinvar(split_ind)
        ess_tails.append(_ess(split_ind, w, v))
    return ModernDiagnostics(
        rhat=torch.maximum(rhat_bulk, rhat_folded),
        rhat_bulk=rhat_bulk,
        rhat_folded=rhat_folded,
        ess_bulk=ess_bulk,
        ess_tail=torch.minimum(*ess_tails),
    )


@dataclasses.dataclass
class Summary:
    """Per-parameter posterior summary table (``[P]`` tensors;
    ``quantiles`` ``[Q, P]``). ``str()`` renders the aligned table; the
    rows follow ``names``."""

    names: tuple
    mean: torch.Tensor
    sd: torch.Tensor
    mcse_mean: torch.Tensor
    mcse_sd: torch.Tensor
    q_levels: tuple
    quantiles: torch.Tensor
    ess_bulk: torch.Tensor
    ess_tail: torch.Tensor
    rhat: torch.Tensor

    def __str__(self) -> str:
        header = (["parameter", "mean", "sd", "mcse_mean", "mcse_sd"]
                  + [f"q{100 * q:g}" for q in self.q_levels]
                  + ["ess_bulk", "ess_tail", "rhat"])
        rows = [header]
        for i, name in enumerate(self.names):
            rows.append(
                [name]
                + [f"{float(a[i]):.3f}" for a in
                   (self.mean, self.sd, self.mcse_mean, self.mcse_sd)]
                + [f"{float(self.quantiles[j, i]):.3f}"
                   for j in range(len(self.q_levels))]
                + [f"{float(self.ess_bulk[i]):.0f}",
                   f"{float(self.ess_tail[i]):.0f}",
                   f"{float(self.rhat[i]):.4f}"]
            )
        widths = [max(len(r[c]) for r in rows) for c in range(len(header))]
        return "\n".join(
            "  ".join(cell.rjust(w) for cell, w in zip(r, widths))
            for r in rows
        )


def summary(sample: torch.Tensor, *, quantiles=(0.05, 0.5, 0.95),
            param_names=None, time_major: bool = False) -> Summary:
    """Posterior summary per parameter (``mini_mcmc_tpu/diagnostics.py:
    174-240``, the arviz ``summary`` analog): mean, sd, Monte-Carlo
    standard errors, quantiles, bulk and tail ESS and the rank-normalized
    R-hat.

    The MCSE of the mean is ``sd / sqrt(ess_bulk)``; that of the sd uses
    Vehtari et al. (2021)'s approximation with ``ess_sd = min(ess(x),
    ess(x^2))``. Both are sampling errors, not posterior uncertainty.

    Args:
        sample: ``[chains, observations, parameters]`` cube, or
            ``[observations, chains, parameters]`` with ``time_major=True``.
        quantiles: the quantile levels to report.
        param_names: ``[P]`` row labels (default ``x0..x{P-1}``).

    A cube sharded on its chain axis (a DTensor) is gathered whole on
    every rank first (one all-gather).
    """
    sample = torch.as_tensor(full_cube(sample, time_major)).to(torch.float32)
    if sample.dim() != 3:
        raise ValueError(
            f"sample must be a 3-D cube; got shape {tuple(sample.shape)}"
        )
    if time_major:
        sample = sample.transpose(0, 1)
    c, n, p = sample.shape
    if param_names is None:
        param_names = tuple(f"x{i}" for i in range(p))
    param_names = tuple(param_names)
    if len(param_names) != p:
        raise ValueError(f"{len(param_names)} param_names for {p} parameters")
    q_levels = tuple(float(q) for q in quantiles)

    diag = rank_normalized_diagnostics(sample)
    pm = sample.permute(2, 0, 1).reshape(p, c * n)
    mean = torch.mean(pm, dim=1)
    sd = torch.std(pm, dim=1, correction=1)
    qs = _quantile(pm, q_levels)
    del pm
    ess = []  # split-ESS of x and of x^2, for the sd's MCSE
    for cube in (sample, sample * sample):
        splitted = _splitcat(cube)
        within, var = _withinvar(splitted)
        ess.append(_ess(splitted, within, var))
    ess_sd = torch.minimum(*ess)
    mcse_mean = sd / torch.sqrt(diag.ess_bulk)
    # Vehtari et al. 2021 app. A: fac = e (1 - 1/ess)^(ess-1) - 1, computed
    # as expm1(1 + (ess-1) log1p(-1/ess)) (the power form cancels in
    # float32); ess clamped just above 1, where fac ~ e - 1, i.e. mcse_sd ~
    # 1.3 sd, the "no information" answer, instead of a NaN
    safe_ess = torch.clamp(ess_sd, min=1.0 + 1e-6)
    fac = torch.expm1(1.0 + (safe_ess - 1.0) * torch.log1p(-1.0 / safe_ess))
    mcse_sd = sd * torch.sqrt(torch.clamp(fac, min=0.0))
    return Summary(
        names=param_names, mean=mean, sd=sd, mcse_mean=mcse_mean,
        mcse_sd=mcse_sd, q_levels=q_levels, quantiles=qs,
        ess_bulk=diag.ess_bulk, ess_tail=diag.ess_tail, rhat=diag.rhat,
    )
