"""``transform=`` on the port's samplers (``tests/test_transforms.py``'s
sampler cases): HMC, MALA, NUTS, MH and tempering with a transform equal
the same sampler on ``tf.wrap(target)`` from ``tf.to_y(x0)`` bit for bit,
their samples mapped by ``to_x``, on every tier's plain twin; a metric
composes with a transform (estimated from, and whitening, the
unconstrained ensemble); the fused MH and tempering tiers refuse a
transform; ``examples/constrained_transforms.py``'s moments at 64 chains.
The bijectors, wrapped targets and kernel twins against the JAX package are
in ``tests/test_torch_transforms.py``.
"""

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import (
    CoordinateTransform,
    Target,
    identity,
    interval,
    isotropic_gaussian_proposal,
    positive,
)
from mini_mcmc_torch.models import transforms as T
from mini_mcmc_torch.samplers import _unconstrained_positions

torch.set_num_threads(1)

CPU = dict(device="cpu")
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _scale_location():
    """x0 > 0 a scale, x1 | x0 ~ N(0, x0^2), x0 ~ Exp(1)
    (tests/test_transforms.py:291-301)."""

    def logp(x):
        return -x[..., 0] - 0.5 * (x[..., 1] / x[..., 0]) ** 2 - torch.log(
            x[..., 0])

    return Target(logp=logp)


def _natural_init(n):
    x0 = mt.init_det(n, 2, **CPU)
    x0[:, 0] = torch.exp(0.3 * x0[:, 0])
    return x0


def _same_cube(auto, manual_cube, tf):
    """The transform= sampler's cube equals the manual wrap's, mapped."""
    torch.testing.assert_close(auto, tf.to_x(manual_cube), rtol=0, atol=0)


@pytest.mark.parametrize("tier", [False, True, "full"])
def test_hmc_and_mala_transform_equal_the_manual_wrap(tier):
    # tests/test_transforms.py:245-268 on every tier's twin: the same
    # kernel target and draws, so the same chains bit for bit
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(16)
    kw = dict(use_pallas=tier, steps_per_call=4, **CPU)
    auto = mt.HMC(_scale_location(), x0, 0.05, 3, transform=tf, **kw).seed(4)
    manual = mt.HMC(tf.wrap(_scale_location()), tf.to_y(x0), 0.05, 3,
                    **kw).seed(4)
    _same_cube(auto.run(20, 8), manual.run(20, 8), tf)
    torch.testing.assert_close(auto.state.positions, manual.state.positions,
                               rtol=0, atol=0)
    assert (auto.positions[:, 0] > 0).all() and auto.transform is tf
    ml = mt.MALA(_scale_location(), x0, 0.3, transform=tf, **kw).seed(9)
    ml_manual = mt.MALA(tf.wrap(_scale_location()), tf.to_y(x0), 0.3,
                        **kw).seed(9)
    _same_cube(ml.run(20, 4), ml_manual.run(20, 4), tf)
    tuned = ml.tuned(24)
    assert tuned.transform is tf and (tuned.run(8)[..., 0] > 0).all()


@pytest.mark.parametrize("tier", [False, True, "full"])
def test_nuts_transform_equals_the_manual_wrap(tier):
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(16)
    auto = mt.NUTS(_scale_location(), x0, 0.8, use_pallas=tier,
                   transform=tf, **CPU).seed(5)
    manual = mt.NUTS(tf.wrap(_scale_location()), tf.to_y(x0), 0.8,
                     use_pallas=tier, **CPU).seed(5)
    _same_cube(auto.run(15, 10), manual.run(15, 10), tf)
    assert (auto.positions[:, 0] > 0).all()
    torch.testing.assert_close(auto.divergences, manual.divergences)


def test_mh_and_tempering_transform_equal_the_manual_wrap():
    # tests/test_transforms.py:345-391
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(32)
    walk = isotropic_gaussian_proposal(0.6)
    mh = mt.MetropolisHastings(_scale_location(), walk, x0, transform=tf,
                               **CPU).seed(3)
    manual = mt.MetropolisHastings(tf.wrap(_scale_location()), walk,
                                   tf.to_y(x0), **CPU).seed(3)
    _same_cube(mh.run(60, 20), manual.run(60, 20), tf)
    assert (mh.positions[:, 0] > 0).all()
    # tuned() tunes on the kernel's (unconstrained) target and keeps the
    # transform
    tuned = mh.tuned(50)
    assert tuned.transform is tf and (tuned.run(50)[..., 0] > 0).all()
    assert tuned.scale_factor != 1.0

    pt = mt.ParallelTempering(_scale_location(), x0, betas=(1.0, 0.5),
                              proposal_std=0.7, steps_per_call=5,
                              transform=tf, **CPU).seed(6)
    pt_manual = mt.ParallelTempering(
        tf.wrap(_scale_location()), tf.to_y(x0), betas=(1.0, 0.5),
        proposal_std=0.7, steps_per_call=5, **CPU).seed(6)
    s = pt.run(50, 25)
    assert s.shape == (32, 50, 2)
    _same_cube(s, pt_manual.run(50, 25), tf)
    torch.testing.assert_close(pt.positions, tf.to_x(pt_manual.positions))
    assert (pt.positions[:, 0] > 0).all()
    rt = pt.retuned(2)
    assert rt.transform is tf and (rt.run(20)[..., 0] > 0).all()


def test_fused_mh_and_tempering_refuse_a_transform():
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(8)
    with pytest.raises(ValueError, match="transformed instance"):
        mt.MetropolisHastings(_scale_location(),
                              isotropic_gaussian_proposal(0.6), x0,
                              use_pallas="full", transform=tf, **CPU)
    with pytest.raises(ValueError, match="transformed instance"):
        mt.ParallelTempering(_scale_location(), x0, use_pallas="full",
                             transform=tf, **CPU)
    # the identity transform is no transform
    ident = CoordinateTransform({}, dim=2)
    mh = mt.MetropolisHastings(mt.gaussian2d([0, 0], [[1, 0], [0, 1]]),
                               isotropic_gaussian_proposal(0.6), x0,
                               use_pallas="full", transform=ident, **CPU)
    assert mh.kernel_target is mh.target


def test_transform_composes_with_metric_warmup():
    # tests/test_transforms.py:270-296: the metric is estimated from, and
    # whitens, the unconstrained ensemble; samples stay natural
    tf = CoordinateTransform({0: positive()}, dim=2)
    s = mt.HMC(_scale_location(), _natural_init(64), 0.1, 5, transform=tf,
               **CPU).seed(6)
    rough = s.tuned(60)
    y = _unconstrained_positions(rough)
    torch.testing.assert_close(y, rough.state.positions)
    torch.testing.assert_close(tf.to_x(y), rough.positions)
    pre = rough.reconditioned("diag")
    torch.testing.assert_close(pre.metric.scale,
                               mt.estimate_preconditioner(y, "diag").scale)
    # under the metric, the map back to x is to_x after L
    torch.testing.assert_close(pre.positions, tf.to_x(pre.metric.to_x(
        pre.state.positions)))
    warmed = s.warmed_up(60, "diag")
    assert warmed.metric is not None and warmed.transform is tf
    assert warmed.kernel_target.cuda_transform == ((T.BIJ_POSITIVE, 0.0,
                                                    1.0), identity().cuda)
    x = _np(warmed.run(300, 100)).reshape(-1, 2)
    assert np.isfinite(x).all() and (x[:, 0] > 0).all()
    # x0 ~ Exp(1), x1 | x0 ~ N(0, x0^2)
    assert abs(x[:, 0].mean() - 1.0) < 0.15
    assert abs(x[:, 1].mean()) < 0.2
    # NUTS: reconditioned in unconstrained coordinates, in support
    n = mt.NUTS(_scale_location(), _natural_init(32), 0.8, max_depth=6,
                transform=tf, **CPU).seed(7)
    n.run(0, 60)
    tuned = n.reconditioned("diag")
    assert tuned.transform is tf
    assert (tuned.run(40, 40)[..., 0] > 0).all()


@pytest.mark.parametrize("tier", [False, "full"])
def test_gaussian_metric_over_transform_on_the_twins(tier):
    # the NUTS stage's posterior with x0 > 0 (chip_smoke.py's
    # [nuts_constrained]) whitened over its transform: Whitened<Transformed>
    tf = CoordinateTransform({0: positive()}, dim=2)
    w = tf.wrap(mt.diffable_gaussian2d(MEAN, COV))
    x0 = tf.to_x(mt.init_with_seed(64, 2, seed=7, **CPU))
    n = mt.NUTS(mt.diffable_gaussian2d(MEAN, COV), x0, 0.8, use_pallas=tier,
                max_depth=6, transform=tf, **CPU).seed(7)
    n.run(0, 40)
    dense = n.reconditioned("dense")
    assert dense.kernel_target.cuda_affine
    assert dense.kernel_target.cuda_transform == w.cuda_transform
    x = _np(dense.run(60, 20)).reshape(-1, 2)
    assert (x[:, 0] > 0).all()
    # E[x] of the truncated Gaussian: 2 sqrt(2 / pi), 1 + sqrt(2 / pi)
    np.testing.assert_allclose(x.mean(0), [1.595769, 1.797885], atol=0.25)


def test_conjugate_example_moments():
    # examples/constrained_transforms.py:85-96 at 64 chains
    n_wait, sum_wait, a0, b0 = 40, 13.1, 2.0, 1.0
    n_trials, k, al0, be0 = 60, 21, 1.0, 1.0

    def logp(xs):
        lam, p = xs[..., 0], xs[..., 1]
        return ((a0 + n_wait - 1.0) * torch.log(lam) - (b0 + sum_wait) * lam
                + (al0 + k - 1.0) * torch.log(p)
                + (be0 + n_trials - k - 1.0) * torch.log1p(-p))

    tf = CoordinateTransform({0: positive(), 1: interval(0.0, 1.0)}, dim=2)
    x0 = tf.to_x(mt.init_with_seed(64, 2, seed=7, **CPU))
    nuts = mt.NUTS(Target(logp=logp), x0, 0.8, transform=tf, **CPU).seed(7)
    x = _np(nuts.run(250, 150)).reshape(-1, 2)
    a, b = a0 + n_wait, b0 + sum_wait
    al, be = al0 + k, be0 + n_trials - k
    assert (x[:, 0] > 0).all() and ((x[:, 1] > 0) & (x[:, 1] < 1)).all()
    assert abs(x[:, 0].mean() - a / b) < 0.05
    assert abs(x[:, 0].var() - a / b**2) < 0.02
    assert abs(x[:, 1].mean() - al / (al + be)) < 0.02
    assert abs(x[:, 1].var() - al * be / ((al + be) ** 2
                                          * (al + be + 1.0))) < 0.005
