"""Affine-invariant ensemble sampling of a badly scaled Gaussian.

Counterpart of ``examples/ensemble_walkers.py``: the Goodman & Weare
stretch move is affine-equivariant, so a target with a 100:1 axis scale
ratio and strong correlation — which forces an isotropic random-walk
proposal down to the smallest scale — costs the ensemble sampler nothing.
Same budget, same target, ESS side by side.
"""

import numpy as np

from .. import (
    EnsembleSampler,
    MetropolisHastings,
    init_with_seed,
    split_rhat_mean_ess,
)
from ..models import gaussian2d, isotropic_gaussian_proposal

# correlated, badly scaled: std 10 and 0.1, correlation 0.6
COV = [[100.0, 0.6], [0.6, 0.01]]


def main(device="cuda"):
    target = gaussian2d([0.0, 0.0], COV)
    init = 0.1 * init_with_seed(64, 2, seed=0, device=device)

    # Isotropic MH must propose at the SMALL scale to accept at all.
    mh = MetropolisHastings(
        target, isotropic_gaussian_proposal(0.1), init, device=device
    ).seed(1)
    mh_sample = mh.run(2000, 500)
    mh_rhat, mh_ess = split_rhat_mean_ess(mh_sample)

    es = EnsembleSampler(target, init, walkers_per_ensemble=64,
                         device=device).seed(1)
    es_sample = es.run(2000, 500)
    es_rhat, es_ess = split_rhat_mean_ess(es_sample)

    print("target: 2D Gaussian, std = (10, 0.1), corr = 0.6")
    print(f"isotropic MH   ESS {mh_ess.cpu().numpy().round(1)}"
          f"   R-hat {mh_rhat.cpu().numpy().round(3)}")
    print(f"ensemble (G&W) ESS {es_ess.cpu().numpy().round(1)}"
          f"   R-hat {es_rhat.cpu().numpy().round(3)}")

    flat = es_sample.cpu().numpy().reshape(-1, 2)
    print("ensemble sample moments:",
          "mean", flat.mean(axis=0).round(2),
          "var", flat.var(axis=0).round(2),
          "cov01", np.cov(flat.T)[0, 1].round(2))


if __name__ == "__main__":
    main()
