"""Cross-sampler agreement in the port: the twin of
``tests/test_cross_sampler.py`` with its targets, seeds, chain counts,
run lengths and bounds, on ``device="cpu"``. MH, HMC, MALA (via
``tuned()``), NUTS, coordinate slice and elliptical slice all sample the
same correlated Gaussian; their means, covariances and tail quantiles must
agree with each other and with the analytic values. A fault in any one
kernel's accept rule, integrator, tree bookkeeping or bracket construction
shows as a systematic discrepancy here even when that sampler's own unit
tests pass.
"""

import numpy as np
import torch
from scipy.stats import norm

from mini_mcmc_torch import (
    HMC,
    MALA,
    NUTS,
    EllipticalSliceSampler,
    MetropolisHastings,
    SliceSampler,
    init_det,
)
from mini_mcmc_torch.models import (
    Target,
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
)

MEAN = np.array([1.0, -2.0])
COV = np.array([[2.0, 0.8], [0.8, 1.5]])
CPU = dict(device="cpu")


def _flat(sample):
    return sample.numpy().reshape(-1, 2)


def _init():
    return init_det(8, 2, **CPU)


def _run_all():
    mh = MetropolisHastings(
        gaussian2d(MEAN, COV), isotropic_gaussian_proposal(1.5), _init(),
        **CPU).seed(1)
    hmc = HMC(diffable_gaussian2d(MEAN, COV), _init(), 0.3, 15,
              **CPU).seed(2)
    # MALA at a dual-averaged step size (the tuned() workflow end-to-end)
    mala = MALA(diffable_gaussian2d(MEAN, COV), _init(), step_size=2.0,
                **CPU).seed(6).tuned(300)
    nuts = NUTS(diffable_gaussian2d(MEAN, COV), _init(), 0.8, **CPU).seed(3)
    sl = SliceSampler(gaussian2d(MEAN, COV), _init(), **CPU).seed(4)
    # elliptical: the target IS the prior (flat likelihood), sampled
    # exactly through the ellipse construction
    ell = EllipticalSliceSampler(
        Target(logp=lambda x: torch.zeros(x.shape[:-1])),
        _init(),
        prior_mean=torch.tensor(MEAN, dtype=torch.float32),
        prior_scale=torch.tensor(np.linalg.cholesky(COV),
                                 dtype=torch.float32),
        **CPU,
    ).seed(5)
    return {
        "mh": _flat(mh.run(4000, 1000)),
        "hmc": _flat(hmc.run(2500, 500)),
        "mala": _flat(mala.run(4000, 1000)),
        "nuts": _flat(nuts.run(1500, 500)),
        "slice": _flat(sl.run(2500, 500)),
        "elliptical": _flat(ell.run(2500, 500)),
    }


def test_cross_sampler_moments_and_quantiles():
    samples = _run_all()
    sd = np.sqrt(np.diag(COV))
    for name, flat in samples.items():
        np.testing.assert_allclose(
            flat.mean(axis=0), MEAN, atol=0.2, err_msg=f"{name} mean"
        )
        np.testing.assert_allclose(
            np.cov(flat.T), COV, atol=0.4, err_msg=f"{name} cov"
        )
        # marginal 5% / 95% quantiles vs analytic Gaussian
        for d in range(2):
            for q in (0.05, 0.95):
                got = np.quantile(flat[:, d], q)
                want = MEAN[d] + sd[d] * norm.ppf(q)
                assert abs(got - want) < 0.35, (name, d, q, got, want)

    # pairwise agreement between samplers (tighter than the analytic bound)
    means = {k: v.mean(axis=0) for k, v in samples.items()}
    for a in means:
        for b in means:
            np.testing.assert_allclose(
                means[a], means[b], atol=0.3, err_msg=f"{a} vs {b}"
            )
