"""Rank-normalized convergence diagnostics (Vehtari et al. 2021).

Counterpart of ``mini_mcmc_tpu/diagnostics.py:41-146,261-289``: the
rank-normalized split R-hat (bulk and folded, STANDARD orientation
``sqrt(var / W)``), bulk ESS and tail ESS, built on a double ``argsort``,
``torch.special.ndtri`` and ``torch.quantile``. ``torch.quantile`` takes at
most 2**24 draws per parameter; subsample larger cubes (contiguously: chains
are exchangeable) as the flagship gate does.
"""

from __future__ import annotations

import dataclasses

import torch

from .stats import _ess, _splitcat, _withinvar


def _rank_normalize_pm(flat_pm: torch.Tensor) -> torch.Tensor:
    """Rank-normalize ``[P, S]`` draws to z-scores: ordinal ranks by double
    argsort, then ``z = Phi^-1((r + 1 - 3/8) / (S + 1/4))`` (eq. 14)."""
    s = flat_pm.shape[1]
    # stable, as jnp.argsort: folding around a median that is the midpoint
    # of two draws makes those two draws tie exactly
    order = torch.argsort(flat_pm, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1).to(torch.float32)  # 0-based
    u = (ranks + (1.0 - 0.375)) / (s + 0.25)
    return torch.special.ndtri(u)


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
    """
    sample = torch.as_tensor(sample).to(torch.float32)
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
    median = torch.quantile(pm, 0.5, dim=1)
    folded = torch.abs(sample - median[None, None, :])
    rhat_folded = _standard_split_rhat(_splitcat(_rank_normalize_cube(folded)))

    # tail: ESS of the raw 5% / 95% exceedance indicators (no rank transform)
    q05 = torch.quantile(pm, 0.05, dim=1)
    q95 = torch.quantile(pm, 0.95, dim=1)
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
