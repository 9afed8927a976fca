"""Gibbs sampling of a 2-component Gaussian mixture with a latent indicator.

Counterpart of ``examples/mixture_gibbs.py``: state ``[x, z]``; ``x | z``
is Gaussian, ``z | x`` is Bernoulli from the posterior responsibility.
"""

import numpy as np

from .. import GibbsSampler, init_det
from ..models import gaussian_mixture_conditional


def main(device="cuda"):
    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    cond = gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0)
    sampler = GibbsSampler(cond, init_det(4, 2, device=device),
                           device=device).seed(42)

    sample = sampler.run(10000, 1000).cpu().numpy()
    xs = sample[:, :, 0].ravel()
    zs = sample[:, :, 1].ravel()

    theo_mean = pi0 * mu0 + (1 - pi0) * mu1
    print("x mean:", xs.mean(), "(theory:", theo_mean, ")")
    print("z=1 frequency:", zs.mean(), "(theory:", 1 - pi0, ")")

    # text histogram of x
    hist, edges = np.histogram(xs, bins=24, range=(-6, 8))
    for h, lo in zip(hist, edges):
        print(f"{lo:6.2f} {'#' * int(60 * h / hist.max())}")


if __name__ == "__main__":
    main()
