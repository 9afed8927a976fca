"""Metric (mass-matrix) adaptation from the chain ensemble.

Counterpart of ``examples/metric_nuts.py``: equilibrate a NUTS ensemble,
whiten from ONE cross-chain covariance snapshot
(``sampler.reconditioned("dense")``), and continue sampling the original
coordinates with the whitened dynamics. On CUDA NUTS takes its fused tier
(:func:`~mini_mcmc_torch.examples.nuts_tier`), the metric whitening its
kernel's target.
"""

from .. import NUTS, init_det, split_rhat_mean_ess
from ..models import diffable_gaussian2d
from . import nuts_tier


def main(device="cuda"):
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    nuts = NUTS(target, init_det(256, 2, device=device), 0.8,
                device=device, **nuts_tier(device)).seed(0)

    nuts.run(100, 200)  # adapt step size + equilibrate the ensemble
    tuned = nuts.reconditioned("dense", seed=1)
    sample = tuned.run(500, 100)

    rhat, ess = split_rhat_mean_ess(sample)
    print("estimated covariance factor L:\n", tuned.metric.chol)
    print("sample shape:", tuple(sample.shape))
    print("mean:", sample.mean(dim=(0, 1)),
          "var:", sample.var(dim=(0, 1), correction=0))
    print("split R-hat:", rhat, "ESS:", ess)


if __name__ == "__main__":
    main()
