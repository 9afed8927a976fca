"""Robust GP regression via elliptical slice sampling.

Counterpart of ``examples/gp_robust_regression.py``: infer a latent
Gaussian process under a heavy-tailed Student-t likelihood. The posterior
``p(f | y) ∝ N(f; 0, K) * Π_i t_ν(y_i − f_i)`` is the shape
``EllipticalSliceSampler`` is built for: the GP prior enters through the
ellipse (one batched ``[C, D] @ [D, D]`` Cholesky matmul per step), the
Student-t likelihood through the accept test, and there is nothing to
tune. The analytic Gaussian-likelihood GP posterior mean gets dragged
toward planted outliers; the Student-t posterior mean shrugs them off.
The data and the starts are drawn with numpy from the example's seeds
(the JAX example draws them with ``jax.random``).
"""

import numpy as np
import torch

from .. import EllipticalSliceSampler, split_rhat_mean_ess
from ..models.base import Target
from ..utils.init import resolve_device

N_POINTS = 48
NOISE_STD = 0.15
NU = 3.0  # Student-t degrees of freedom


def rbf_kernel(x, lengthscale=0.6, amplitude=1.0):
    d2 = (x[:, None] - x[None, :]) ** 2
    return amplitude**2 * torch.exp(-0.5 * d2 / lengthscale**2)


def student_t_loglik(resid, nu, scale):
    """The Student-t log-likelihood of residuals ``[..., N]`` -> ``[...]``
    (up to its constant)."""
    z2 = (resid / scale) ** 2
    return torch.sum(-0.5 * (nu + 1.0) * torch.log1p(z2 / nu), dim=-1)


def make_data(seed=0):
    """``(x, kmat, chol, f_true, y)``: a GP draw on ``N_POINTS`` inputs,
    noisy observations of it and three gross outliers, float32 tensors
    on the host."""
    x = torch.linspace(-3.0, 3.0, N_POINTS)
    kmat = rbf_kernel(x) + 1e-6 * torch.eye(N_POINTS)
    chol = torch.linalg.cholesky(kmat)
    rng = np.random.default_rng(seed)
    f_true = chol @ torch.from_numpy(
        rng.standard_normal(N_POINTS).astype(np.float32))
    y = f_true + NOISE_STD * torch.from_numpy(
        rng.standard_normal(N_POINTS).astype(np.float32))
    # plant three gross outliers
    y[[7, 23, 40]] += torch.tensor([4.0, -5.0, 4.5])
    return x, kmat, chol, f_true, y


def main(device="cuda"):
    # -- synthetic data with outliers ------------------------------------
    x, kmat, chol, f_true, y = make_data(0)

    # -- analytic Gaussian-likelihood GP fit (outlier-sensitive) ---------
    gauss_post_mean = kmat @ torch.linalg.solve(
        kmat + NOISE_STD**2 * torch.eye(N_POINTS), y)

    # -- Student-t likelihood posterior via elliptical slice -------------
    y_dev = y.to(resolve_device(device))
    loglik = Target(logp=lambda f: student_t_loglik(y_dev - f, NU,
                                                    NOISE_STD))
    n_chains = 24
    init = 0.01 * torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n_chains, N_POINTS)).astype(np.float32))
    es = EllipticalSliceSampler(loglik, init.to(device),
                                prior_scale=chol.to(device),
                                device=device).seed(2)
    sample = es.run(1200, 300)
    robust_post_mean = sample.reshape(-1, N_POINTS).mean(dim=0).cpu()

    rhat, ess = split_rhat_mean_ess(sample)
    rmse_gauss = float(torch.sqrt(torch.mean((gauss_post_mean - f_true)
                                             ** 2)))
    rmse_robust = float(torch.sqrt(torch.mean((robust_post_mean - f_true)
                                              ** 2)))

    print(f"latent GP, {N_POINTS} points, 3 planted outliers, "
          f"Student-t(nu={NU}) likelihood")
    print(f"Gaussian-likelihood GP RMSE vs truth: {rmse_gauss:.3f}  "
          "(outliers drag the conjugate fit)")
    print(f"Student-t (elliptical slice) RMSE:    {rmse_robust:.3f}")
    print(f"max split R-hat {float(rhat.max()):.3f}, "
          f"min ESS {float(ess.min()):.0f} "
          f"({n_chains} chains x 1200 draws)")
    assert rmse_robust < rmse_gauss, "robust fit should beat conjugate here"


if __name__ == "__main__":
    main()
