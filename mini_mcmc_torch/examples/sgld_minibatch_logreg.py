"""Large-N Bayesian logistic regression with minibatch SGLD.

Counterpart of ``examples/sgld_minibatch_logreg.py``: stochastic-gradient
Langevin dynamics touches only a ``batch_size``-row minibatch per step, so
the per-step cost is O(B * D) however large the dataset grows. A
polynomially decaying step size (Welling & Teh 2011) shrinks the
discretization bias as the run proceeds; a full-gradient MALA run on the
same posterior is the exact yardstick the SGLD moments are checked
against. The data are drawn with numpy from the example's seed (the JAX
example draws them with ``jax.random``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import (
    MALA,
    SGLD,
    init_det,
    minibatch_grad,
    polynomial_decay,
    summary,
)
from ..models.base import Target
from .logistic_regression_nuts import make_logistic_target


def make_data(n_points, dim, seed=0):
    """``(X [N, D], y [N], true_beta [D])``, float32 numpy arrays:
    Bernoulli labels of a logistic model with weights
    ``linspace(-1, 1, D)``."""
    rng = np.random.default_rng(seed)
    true_beta = np.linspace(-1.0, 1.0, dim).astype(np.float32)
    X = rng.standard_normal((n_points, dim)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ true_beta)))
    y = (rng.uniform(size=n_points) < p).astype(np.float32)
    return X, y, true_beta


def main(n_points=8192, dim=4, n_chains=32, batch_size=256, seed=0,
         device="cuda"):
    X, y, true_beta = make_data(n_points, dim, seed)
    prior_std = 10.0
    inv_prior_var = 1.0 / (prior_std * prior_std)

    # --- minibatch SGLD: O(B) data touched per step ------------------
    grad_fn = minibatch_grad(
        lambda b: -0.5 * inv_prior_var * torch.sum(b * b),
        # summed minibatch log-likelihood: one [B, D] @ [D] matmul
        lambda b, batch: torch.sum(
            batch[1] * (batch[0] @ b) - F.softplus(batch[0] @ b)
        ),
        (X, y),
        batch_size=batch_size,
        device=device,
    )
    sgld = SGLD(
        grad_fn,
        init_det(n_chains, dim, device=device),
        # decaying schedule: bias -> 0 as eps -> 0 (Welling & Teh eq. 2)
        step_size=polynomial_decay(2e-4, 100.0, 0.55),
        seed=42,
        device=device,
    )
    sgld_sample = sgld.run(2000, 2000)
    sgld_mean = sgld_sample.cpu().numpy().reshape(-1, dim).mean(axis=0)

    # --- full-gradient MALA yardstick (exact, O(N) per step) ---------
    # the logistic posterior without its analytic gradient: autograd, as
    # the JAX example differentiates its own
    full = make_logistic_target(X, y, prior_std)
    mala = MALA(Target(logp=full.logp, logp_batch=full.logp_batch),
                init_det(n_chains, dim, device=device), 0.02, seed=42,
                device=device).tuned(500)
    mala_sample = mala.run(2000, 500).cpu().numpy().reshape(-1, dim)
    mala_mean = mala_sample.mean(axis=0)
    mala_std = mala_sample.std(axis=0)

    print(f"data: N={n_points}, minibatch B={batch_size} "
          f"({100.0 * batch_size / n_points:.1f}% touched per step)")
    print("true beta:      ", true_beta)
    print("SGLD post mean: ", sgld_mean)
    print("MALA post mean: ", mala_mean)
    print(summary(sgld_sample,
                  param_names=[f"beta[{i}]" for i in range(dim)]))

    # SGLD must land on the exact sampler's posterior (small O(eps) bias)
    assert np.all(np.abs(sgld_mean - mala_mean) < 4.0 * mala_std + 0.05), (
        sgld_mean, mala_mean, mala_std)
    return sgld_mean


if __name__ == "__main__":
    main()
