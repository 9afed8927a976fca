"""Constrained parameters via the transform layer — no hand-rolled exp.

Counterpart of ``examples/constrained_transforms.py``: two conjugate
posteriors with EXACT moments, written in their NATURAL coordinates and
sampled unconstrained through ``models/transforms.py``:

- a Poisson-process rate ``lam > 0`` with a Gamma(a0, b0) prior over
  exponential waiting times: posterior Gamma(a0 + n, b0 + sum x), handled
  by ``positive()`` (lam = exp(y));
- a Bernoulli success probability ``p in (0, 1)`` with a Beta(al0, be0)
  prior: posterior Beta(al0 + k, be0 + n - k), handled by
  ``interval(0, 1)`` (scaled sigmoid).

The density is written against ``lam`` and ``p`` directly; ``transform=``
adds the Jacobians, and the initial positions, the sample cube and
``.positions`` stay in the natural ranges. On CUDA NUTS takes its fused
tier (:func:`~mini_mcmc_torch.examples.nuts_tier`): the kernel runs the
density traced from ``logp_batch`` inside the transform's bijectors.
"""

import numpy as np
import torch

from .. import NUTS, init_with_seed
from ..models import CoordinateTransform, interval, positive
from ..models.base import Target
from . import nuts_tier

# synthetic sufficient statistics (fixed, so the posterior is exact)
N_WAIT, SUM_WAIT = 40, 13.1  # exponential waiting times
A0, B0 = 2.0, 1.0  # Gamma prior on lam
N_TRIALS, K_SUCC = 60, 21  # Bernoulli trials
AL0, BE0 = 1.0, 1.0  # Beta prior on p


def make_natural_target() -> Target:
    """logp over x = [lam, p] in natural coordinates (lam > 0, 0 < p < 1).

    Supports are enforced by the transform, so this density never sees an
    out-of-range value and needs no guards."""

    def logp_batch(xs):  # [C, 2] -> [C]
        lam, p = xs[:, 0], xs[:, 1]
        log_gamma_post = (A0 + N_WAIT - 1.0) * torch.log(lam) - (
            B0 + SUM_WAIT
        ) * lam
        log_beta_post = (AL0 + K_SUCC - 1.0) * torch.log(p) + (
            BE0 + N_TRIALS - K_SUCC - 1.0
        ) * torch.log1p(-p)
        return log_gamma_post + log_beta_post

    return Target(
        logp=lambda x: logp_batch(x.reshape(-1, 2)).reshape(x.shape[:-1]),
        logp_batch=logp_batch)


def exact_moments():
    a, b = A0 + N_WAIT, B0 + SUM_WAIT
    al, be = AL0 + K_SUCC, BE0 + N_TRIALS - K_SUCC
    return {
        "lam_mean": a / b,
        "lam_var": a / b**2,
        "p_mean": al / (al + be),
        "p_var": al * be / ((al + be) ** 2 * (al + be + 1.0)),
    }


def make_transform() -> CoordinateTransform:
    """``lam = exp(y0) > 0``, ``p = sigmoid-scaled y1 in (0, 1)``."""
    return CoordinateTransform({0: positive(), 1: interval(0.0, 1.0)},
                               dim=2)


def main(n_chains=64, n_collect=500, n_discard=300, device="cuda"):
    transform = make_transform()
    # natural-coordinate starting points (lam > 0, p in (0, 1))
    x0 = transform.to_x(init_with_seed(n_chains, 2, seed=7, device=device))
    # transform= does the wrapping internally: initial positions, the
    # sample cube, and .positions all stay in NATURAL coordinates
    nuts = NUTS(make_natural_target(), x0, 0.8, transform=transform,
                device=device, **nuts_tier(device)).seed(7)
    sample = nuts.run(n_collect, n_discard)
    x = sample.cpu().numpy().reshape(-1, 2)

    ex = exact_moments()
    lam_mean, lam_var = float(x[:, 0].mean()), float(x[:, 0].var())
    p_mean, p_var = float(x[:, 1].mean()), float(x[:, 1].var())
    print(f"lam: mean {lam_mean:.4f} (exact {ex['lam_mean']:.4f}), "
          f"var {lam_var:.5f} (exact {ex['lam_var']:.5f})")
    print(f"p:   mean {p_mean:.4f} (exact {ex['p_mean']:.4f}), "
          f"var {p_var:.6f} (exact {ex['p_var']:.6f})")

    # supports hold by construction, moments by correctness
    assert np.all(x[:, 0] > 0) and np.all((x[:, 1] > 0) & (x[:, 1] < 1))
    assert abs(lam_mean - ex["lam_mean"]) < 0.05
    assert abs(lam_var - ex["lam_var"]) < 0.02
    assert abs(p_mean - ex["p_mean"]) < 0.02
    assert abs(p_var - ex["p_var"]) < 0.005
    return lam_mean, p_mean


if __name__ == "__main__":
    main()
