"""Golden-trajectory regression tests for the port's own random streams:
the twin of ``tests/test_golden_trajectories.py`` at its configurations,
seeds and ``TOL``.

The JAX pins were recorded from threefry streams and do not carry over.
These were recorded from the port on the CPU (f32 state): the lockstep
samplers draw from ``torch.Generator`` streams seeded by the sampler's
seed, and the fused tiers' plain twins (``use_pallas="full"`` for HMC,
NUTS, MH, Gibbs and tempering, and the separable tier at D = 4) from
Philox words keyed by place (chain, step, draw) under the run's key, the
streams the card's kernels draw. They guard against silent behavioural
changes in every sampler kernel, the runners and the seeding discipline.
"""

import numpy as np
import pytest
import torch

from mini_mcmc_torch import (
    HMC,
    NUTS,
    EllipticalSliceSampler,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    SliceSampler,
    geometric_betas,
    init_det,
)
from mini_mcmc_torch.models import (
    Target,
    diffable_gaussian2d,
    gaussian2d,
    gaussian_mixture_conditional,
    isotropic_gaussian_proposal,
    rosenbrock_nd,
    standard_normal,
)

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _mh(**kw):
    return MetropolisHastings(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        isotropic_gaussian_proposal(1.0), init_det(2, 2, **CPU), **kw,
        **CPU).seed(42).run(3, 2)


def _hmc(**kw):
    return HMC(rosenbrock_nd(), init_det(2, 3, **CPU), 0.03, 5, **kw,
               **CPU).seed(42).run(2, 1)


def _nuts(**kw):
    return NUTS(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]),
                init_det(2, 2, **CPU), 0.8, **kw, **CPU).seed(42).run(3, 2)


def _gibbs(**kw):
    return GibbsSampler(
        gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
        init_det(2, 2, **CPU), **kw, **CPU).seed(42).run(2, 1)


def _slice():
    return SliceSampler(gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                        init_det(2, 2, **CPU), **CPU).seed(42).run(3, 2)


def _elliptical():
    lik = Target(logp=lambda x: -0.5 * torch.sum((x - 1.0) ** 2, dim=-1))
    return EllipticalSliceSampler(lik, init_det(2, 2, **CPU),
                                  prior_scale=2.0, **CPU).seed(42).run(3, 2)


def _pt():
    return ParallelTempering(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        init_det(2, 2, **CPU), betas=geometric_betas(4), use_pallas="full",
        **CPU).seed(42).run(3, 2)


def _separable():
    return HMC(standard_normal(), init_det(2, 4, **CPU), 0.1, 5,
               use_pallas="separable", **CPU).seed(42).run(2, 1)


#: (sampler run, recorded cube)
GOLDEN = {
    "mh": (
        _mh,
        np.array([
            [[0.42685047, 0.3454035],
             [-0.16814479, 1.1737242],
             [-0.16814479, 1.1737242]],
            [[-0.37322164, -0.3958033],
             [1.1645962, 0.7113719],
             [1.5931274, 1.1417406]],
        ], np.float32)),
    "hmc": (
        _hmc,
        np.array([
            [[0.40328145, 0.12222803, 0.14455633],
             [0.31770116, 0.13270281, -0.08327781]],
            [[-1.0131502, 0.5494696, 0.37361616],
             [-0.5439146, 0.50013846, 0.4530169]],
        ], np.float32)),
    "nuts": (
        _nuts,
        np.array([
            [[0.33669037, 0.1288094],
             [-1.1638584, 0.03873259],
             [-0.9612034, -1.0207915]],
            [[0.23446237, 0.23033303],
             [0.6588464, -0.19018036],
             [-1.33029, 2.966072]],
        ], np.float32)),
    "gibbs": (
        _gibbs,
        np.array([
            [[-4.022526, 0.0],
             [-2.8866525, 0.0]],
            [[-0.5603069, 1.0],
             [0.56674385, 1.0]],
        ], np.float32)),
    "slice": (
        _slice,
        np.array([
            [[-0.24789643, 0.5374608],
             [0.7717351, -1.5568835],
             [-1.7571949, -1.506248]],
            [[0.9757376, -0.031201601],
             [-0.29269814, -0.27759504],
             [0.36872697, -0.08715463]],
        ], np.float32)),
    "elliptical": (
        _elliptical,
        np.array([
            [[1.2024375, -0.4755861],
             [-1.256795, 0.47589678],
             [2.089415, -1.021458]],
            [[2.1103547, 1.773123],
             [2.0460098, -0.68288374],
             [0.15817499, 0.976527]],
        ], np.float32)),
    "mh_full": (
        lambda: _mh(use_pallas="full"),
        np.array([
            [[-0.48695368, -1.0839462],
             [0.3642733, -0.30067694],
             [1.4663776, 1.484287]],
            [[-0.0011060983, 1.14145],
             [0.867469, -0.3646078],
             [1.6945361, -1.4128411]],
        ], np.float32)),
    "hmc_full": (
        lambda: _hmc(use_pallas="full"),
        np.array([
            [[0.32157743, 0.06847145, 0.07019911],
             [0.21447438, 0.15091874, -0.024075119]],
            [[0.07467818, -0.13798705, 0.5500781],
             [0.03279654, 0.03359894, -0.17489956]],
        ], np.float32)),
    "nuts_full": (
        lambda: _nuts(use_pallas="full"),
        np.array([
            [[0.33669037, 0.1288094],
             [0.30448836, 0.5560076],
             [-0.99955016, 1.9655156]],
            [[0.23446237, 0.23033303],
             [-0.95237005, -0.21006227],
             [-0.04027772, 1.2890716]],
        ], np.float32)),
    "gibbs_full": (
        lambda: _gibbs(use_pallas="full"),
        np.array([
            [[-0.9966054, 0.0],
             [-3.1431684, 0.0]],
            [[2.928368, 1.0],
             [2.6466472, 1.0]],
        ], np.float32)),
    "tempering_full": (
        _pt,
        np.array([
            [[0.33669037, 0.1288094],
             [0.33669037, 0.1288094],
             [0.33669037, 0.1288094]],
            [[-0.0011060983, 1.14145],
             [0.867469, -0.3646078],
             [-0.901222, 2.0005817]],
        ], np.float32)),
    "separable": (
        _separable,
        np.array([
            [[0.45291677, -0.8991696, 0.6562857, -1.6642116],
             [-0.15153348, -0.2871743, 0.46519423, -0.45432296]],
            [[-0.24439867, 0.94055986, 1.3005853, 0.34326208],
             [-0.3275777, 1.2628517, 1.9930894, 0.525316]],
        ], np.float32)),
}


@pytest.mark.parametrize("case", list(GOLDEN))
def test_golden(case):
    run, want = GOLDEN[case]
    got = run()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
