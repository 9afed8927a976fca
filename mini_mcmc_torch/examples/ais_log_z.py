"""Marginal likelihood (model evidence) by annealed importance sampling.

Counterpart of ``examples/ais_log_z.py``: AIS anneals a particle
population from the prior to the (unnormalized) posterior and returns an
estimate of ``log p(y)``, checked against the conjugate Gaussian model's
analytic evidence; adaptive SMC does the same with no schedule to choose.

Model: θ ~ N(0, 1), y_i | θ ~ N(θ, 1) for n observations. The evidence is
the Gaussian marginal y ~ N(0, I + 1 1ᵀ), available in closed form.
"""

import math

import numpy as np
import torch

from .. import ais_log_z, smc_log_z
from ..models.base import Target
from ..utils.init import resolve_device

Y = np.asarray([0.8, 1.4, -0.3, 1.1, 0.6], np.float32)
_LOG_2PI = math.log(2 * math.pi)


def batch_logp(theta, y):
    """``[N, 1] -> [N]``: the unnormalized posterior, prior times
    likelihood WITH their Gaussian constants, so that the AIS normalizing
    constant IS the evidence ``p(y)``; ``y`` the ``[n]`` observations on
    ``theta``'s device."""
    t = theta[:, 0]
    log_prior = -0.5 * (t**2 + _LOG_2PI)
    log_lik = torch.sum(-0.5 * ((y[None, :] - t[:, None]) ** 2 + _LOG_2PI),
                        dim=1)
    return log_prior + log_lik


def exact_log_z(y=Y) -> float:
    """The analytic evidence: ``y ~ N(0, I + 1 1^T)``."""
    y = np.asarray(y, np.float64)
    n = y.shape[0]
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    quad = float(y @ np.linalg.solve(cov, y))
    return -0.5 * (n * np.log(2 * np.pi) + logdet + quad)


def main(device="cuda"):
    y = torch.as_tensor(Y, device=resolve_device(device))
    n = y.shape[0]
    target = Target(
        logp=lambda x: batch_logp(x.reshape(-1, 1), y).reshape(x.shape[:-1]),
        logp_batch=lambda theta: batch_logp(theta, y))

    r = ais_log_z(
        target, n_particles=8192, dim=1, betas=64, n_mh_steps=2,
        proposal_std=0.5, seed=0, device=device,
    )
    true = exact_log_z()

    # The adaptive sibling: SMC picks each temperature increment from the
    # population's incremental-weight ESS.
    s = smc_log_z(target, n_particles=8192, dim=1, proposal_std=0.5,
                  seed=0, device=device)

    print(f"n = {n} observations, 8192 particles")
    print(f"AIS log evidence      {float(r.log_z):+.4f}  (64 fixed rungs)")
    print(f"SMC log evidence      {float(s.log_z):+.4f}  "
          f"({s.n_stages} adaptive stages)")
    print(f"analytic log evidence {true:+.4f}")
    print(f"AIS weight ESS        {float(r.weight_ess):.2f} "
          "(near 1 = schedule fine enough)")
    assert abs(float(r.log_z) - true) < 0.05
    assert abs(float(s.log_z) - true) < 0.05
    return float(r.log_z)


if __name__ == "__main__":
    main()
