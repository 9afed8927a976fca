"""Bayesian logistic regression with NUTS — a realistic posterior.

Counterpart of ``examples/logistic_regression_nuts.py``: the log posterior
of logistic regression over a design matrix is one ``[C, D] @ [D, N]``
matmul per evaluation. A custom ``Target`` with a batch form and an
analytic gradient. The data are drawn with numpy from the example's seed
(the JAX example draws them with ``jax.random``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import NUTS, init_det, rank_normalized_diagnostics, run_stats
from ..models.base import Target


def make_logistic_target(X, y, prior_std=10.0):
    """Log posterior of logistic regression: Bernoulli likelihood with a
    N(0, prior_std^2) prior on the weights. ``X`` ``[N, D]`` and ``y``
    ``[N]`` (arrays or tensors) go to the device of the states the
    densities are called on."""
    X = torch.as_tensor(np.asarray(X, np.float32))
    y = torch.as_tensor(np.asarray(y, np.float32))
    inv_prior_var = 1.0 / (prior_std * prior_std)
    on = {}

    def data(like):
        if like.device not in on:
            on[like.device] = (X.to(like.device), y.to(like.device))
        return on[like.device]

    def logp(beta):  # [..., D] -> [...]
        xs, ys = data(beta)
        z = beta @ xs.T  # [..., N]
        # sum_i [y_i z_i - softplus(z_i)] — numerically stable Bernoulli
        loglik = torch.sum(ys * z - F.softplus(z), dim=-1)
        return loglik - 0.5 * inv_prior_var * torch.sum(beta * beta, dim=-1)

    def logp_batch(betas):  # [C, D] -> [C]
        xs, ys = data(betas)
        z = betas @ xs.T  # [C, N]
        loglik = torch.sum(ys[None, :] * z - F.softplus(z), dim=1)
        return loglik - 0.5 * inv_prior_var * torch.sum(betas * betas, dim=1)

    def grad(beta):  # [..., D] -> [..., D]
        xs, ys = data(beta)
        resid = ys - torch.sigmoid(beta @ xs.T)  # [..., N]
        return resid @ xs - inv_prior_var * beta

    return Target(logp=logp, logp_batch=logp_batch, grad=grad)


def main(n_points=256, dim=4, seed=0, device="cuda"):
    # synthetic data from known weights
    rng = np.random.default_rng(seed)
    true_beta = np.linspace(-1.5, 1.5, dim).astype(np.float32)
    X = rng.standard_normal((n_points, dim)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ true_beta)))
    y = (rng.uniform(size=n_points) < p).astype(np.float32)

    target = make_logistic_target(X, y)
    # the lockstep tier on every device: Kernel 4 would run the density
    # traced from logp_batch, and softplus is outside the code generator's
    # table (derive_logp_dc)
    sampler = NUTS(target, init_det(4, dim, device=device), 0.8,
                   device=device).seed(42)
    sample = sampler.run(1000, 500)

    flat = sample.cpu().numpy().reshape(-1, dim)
    post_mean = flat.mean(axis=0)
    print("true beta:     ", true_beta)
    print("posterior mean:", post_mean)
    print(run_stats(sample))
    # rank-normalized R-hat, bulk/tail ESS (Vehtari et al. 2021)
    print(rank_normalized_diagnostics(sample))
    print("divergences:", int(sampler.divergences.sum()))

    # parameter recovery within posterior uncertainty
    post_std = flat.std(axis=0)
    assert np.all(np.abs(post_mean - true_beta) < 4 * post_std + 0.5)
    return post_mean


if __name__ == "__main__":
    main()
