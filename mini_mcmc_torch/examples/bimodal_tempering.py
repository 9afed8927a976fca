"""Replica exchange on a well-separated bimodal mixture.

Counterpart of ``examples/bimodal_tempering.py``: a single-temperature
random-walk sampler started in the left mode of 0.3*N(-8, 0.5^2) +
0.7*N(+8, 0.5^2) essentially never crosses the 32-sigma barrier, while
``ParallelTempering`` on the same budget recovers the 70/30 mode weights
through the temperature ladder.
"""

import math

import numpy as np
import torch

from .. import (
    MetropolisHastings,
    ParallelTempering,
    geometric_betas,
    tune_betas,
)
from ..models import Target, isotropic_gaussian_proposal
from ..utils.init import resolve_device

W_PLUS = 0.7  # weight of the +8 mode


def bimodal():
    """The mixture over ``x[..., 0]``: ``logp`` takes ``[..., 1]``,
    ``logp_batch`` ``[C, 1]``."""

    def logp(x):
        a = math.log(1 - W_PLUS) - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = math.log(W_PLUS) - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    def logp_batch(xs):
        a = math.log(1 - W_PLUS) - 0.5 * ((xs[:, 0] + 8.0) / 0.5) ** 2
        b = math.log(W_PLUS) - 0.5 * ((xs[:, 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, logp_batch=logp_batch)


def main(device="cuda"):
    target = bimodal()
    # every chain starts in the 30% mode
    init = torch.full((16, 1), -8.0, device=resolve_device(device))

    mh = MetropolisHastings(
        target, isotropic_gaussian_proposal(1.0), init, device=device
    ).seed(0)
    stuck = mh.run(2000, 500).cpu().numpy()
    print(f"single-temperature MH:  P(x > 0) = {np.mean(stuck > 0):.3f}"
          f"   (truth {W_PLUS})  <- stuck in the starting mode")

    betas = geometric_betas(8, beta_min=0.01)
    pt = ParallelTempering(target, init, betas=betas, proposal_std=1.0,
                           device=device)
    pt = pt.seed(0)
    sample = pt.run(2000, 500).cpu().numpy()
    print(f"parallel tempering:     P(x > 0) = {np.mean(sample > 0):.3f}"
          f"   (truth {W_PLUS})")

    rates = pt.swap_acceptance.cpu().numpy()
    print("ladder (beta -> beta):  swap acceptance EWMA")
    for (b1, b2), r in zip(zip(betas, betas[1:]), rates):
        print(f"  {b1:6.3f} <-> {b2:6.3f}   {r:.2f}")

    # Re-space the ladder at equal increments of the measured
    # communication barrier (Syed et al. 2021) and run again: per-pair
    # swap rates even out.
    tuned = tune_betas(betas, rates)
    pt2 = ParallelTempering(target, init, betas=tuned, proposal_std=1.0,
                            device=device)
    pt2.seed(0).run(2000, 500)
    r2 = pt2.swap_acceptance.cpu().numpy()
    print(f"tuned ladder:           swap rates "
          f"{rates.min():.2f}-{rates.max():.2f} -> "
          f"{r2.min():.2f}-{r2.max():.2f}")

    hist, edges = np.histogram(sample.ravel(), bins=25, range=(-10, 10))
    for h, lo in zip(hist, edges):
        print(f"{lo:6.1f} {'#' * int(60 * h / hist.max())}")


if __name__ == "__main__":
    main()
