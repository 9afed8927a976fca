"""``transform=`` on the port's samplers (``tests/test_transforms.py``'s
sampler cases): HMC, MALA, NUTS, MH and tempering with a transform equal
the same sampler on ``tf.wrap(target)`` from ``tf.to_y(x0)`` bit for bit,
their samples mapped by ``to_x``, on every tier's plain twin; a metric
composes with a transform (estimated from, and whitening, the
unconstrained ensemble); the fused MH and tempering tiers (Kernels 5 and
8's twins) run a transform and refuse a whitened target, and their
transformed density equals the JAX package's wrap;
``examples/constrained_transforms.py``'s moments at 64 chains.
The bijectors, wrapped targets and kernel twins against the JAX package are
in ``tests/test_torch_transforms.py``.
"""

import math

import jax
import jax.numpy as jnp
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
    lower_bounded,
    positive,
    precondition_target,
    upper_bounded,
)
from mini_mcmc_torch.models import transforms as T
from mini_mcmc_torch.ops.kernels.mh_full import (
    mh_instance,
    mh_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.pt_full import pt_instance
from mini_mcmc_torch.samplers import _unconstrained_positions
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models import transforms as J

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


def _mixture():
    """The tempering stage's bimodal target (bench.py:858-880) with its
    CUDA functor."""
    lw0, lw1 = math.log(0.3), math.log(0.7)

    def logp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                  cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))


def test_fused_mh_and_tempering_run_a_transform():
    # use_pallas="full" with transform= runs Kernels 5 and 8's transformed
    # instances on CUDA and their twins here: the manual wrap's cube bit
    # for bit, the same Philox words on the wrapped density
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(32)
    g = mt.gaussian2d(MEAN, COV)
    walk = isotropic_gaussian_proposal(0.8)
    kw = dict(use_pallas="full", steps_per_call=4, **CPU)
    calls = mh_multistep_plain.calls
    mh = mt.MetropolisHastings(g, walk, x0, transform=tf, **kw).seed(3)
    manual = mt.MetropolisHastings(tf.wrap(g), walk, tf.to_y(x0),
                                   **kw).seed(3)
    _same_cube(mh.run(40, 20), manual.run(40, 20), tf)
    assert mh_multistep_plain.calls == calls + 30
    assert (mh.positions[:, 0] > 0).all()
    # the instance the card runs: Gaussian2D inside Transformed, D = 2
    assert mh_instance(mh.kernel_target, walk, torch.float32, 2) == (1, 0, 0)
    assert mh.kernel_target.cuda_transform == tf.cuda_form

    itf = CoordinateTransform({0: interval(-24.0, 24.0)}, dim=1)
    xp = torch.full((32, 1), -8.0)
    kw = dict(betas=mt.geometric_betas(4, 0.01), proposal_std=0.4,
              steps_per_call=5, use_pallas="full", **CPU)
    pt = mt.ParallelTempering(_mixture(), xp, transform=itf, **kw).seed(6)
    pt_manual = mt.ParallelTempering(itf.wrap(_mixture()), itf.to_y(xp),
                                     **kw).seed(6)
    s = pt.run(30, 10)
    _same_cube(s, pt_manual.run(30, 10), itf)
    assert ((s > -24.0) & (s < 24.0)).all()
    assert pt_instance(pt.kernel_target, 4, 1) == 3
    torch.testing.assert_close(pt.swap_acceptance, pt_manual.swap_acceptance,
                               rtol=0, atol=0)
    # the identity transform is no transform
    ident = CoordinateTransform({}, dim=2)
    mh = mt.MetropolisHastings(mt.gaussian2d([0, 0], [[1, 0], [0, 1]]),
                               isotropic_gaussian_proposal(0.6), x0,
                               use_pallas="full", transform=ident, **CPU)
    assert mh.kernel_target is mh.target


def test_fused_mh_and_tempering_refuse_a_whitened_target():
    # Kernels 5 and 8 take a transformed target, never a whitened one
    # (the JAX MH and tempering take no metric=)
    g = mt.gaussian2d(MEAN, COV)
    pre = mt.Preconditioner("diag", scale=torch.tensor([2.0, 0.5]))
    walk = isotropic_gaussian_proposal(0.8)
    tf = CoordinateTransform({0: positive()}, dim=2)
    for target in (precondition_target(g, pre),
                   precondition_target(tf.wrap(g), pre)):
        with pytest.raises(ValueError, match="whitened"):
            mh_instance(target, walk, torch.float32, 2)
        with pytest.raises(ValueError, match="whitened"):
            pt_instance(target, 8, 2)
    # instances that do not exist are named: a transformed Gaussian at
    # D = 3, any transformed integer walk
    with pytest.raises(ValueError, match="transformed"):
        pt_instance(CoordinateTransform({0: positive()}, dim=3).wrap(
            mt.rosenbrock_nd()), 8, 3)
    pois = CoordinateTransform({0: positive()}, dim=1).wrap(
        mt.poisson_target(4.0))
    with pytest.raises(ValueError, match=r"int32, D=1, transformed\)"):
        mh_instance(pois, mt.random_walk_int_proposal(), torch.int32, 1)
    # an integer state takes no transform on any tier (the JAX package
    # walks it as float y: ROADMAP.md, Queue 3)
    ints = torch.full((8, 1), 3, dtype=torch.int32)
    for tier in (False, "full"):
        with pytest.raises(ValueError, match="torch.int32"):
            mt.MetropolisHastings(
                mt.poisson_target(4.0), mt.random_walk_int_proposal(), ints,
                use_pallas=tier,
                transform=CoordinateTransform({0: positive()}, dim=1), **CPU)


#: (port target, JAX target, port transform table, JAX table, D): the
#: transformed instances of Kernels 5 and 8
TWIN_DENSITIES = {
    "gauss2d": (lambda: mt.gaussian2d(MEAN, COV),
                lambda: jm.gaussian2d(MEAN, COV),
                {0: positive(), 1: upper_bounded(4.0)},
                {0: J.positive(), 1: J.upper_bounded(4.0)}, 2),
    "rosen2": (mt.rosenbrock_nd, jm.rosenbrock_nd,
               {0: positive(), 1: interval(-1.0, 3.0)},
               {0: J.positive(), 1: J.interval(-1.0, 3.0)}, 2),
    "rosen3": (mt.rosenbrock_nd, jm.rosenbrock_nd,
               {0: lower_bounded(-2.0), 2: interval(-1.0, 3.0)},
               {0: J.lower_bounded(-2.0), 2: J.interval(-1.0, 3.0)}, 3),
    "mixture": (_mixture, None, {0: interval(-24.0, 24.0)},
                {0: J.interval(-24.0, 24.0)}, 1),
}


def _jax_mixture():
    lw0, lw1 = math.log(0.3), math.log(0.7)

    def logp_batch(xs):
        a = lw0 - 0.5 * ((xs[:, 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((xs[:, 0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    return jm.Target(logp=lambda x: logp_batch(x[None])[0],
                     logp_batch=logp_batch)


@pytest.mark.parametrize("name", sorted(TWIN_DENSITIES))
def test_twins_transformed_density_matches_jax(name):
    # what the twins of Kernels 5 and 8 evaluate (target.batch_logp of the
    # wrapped target, csrc/targets.cuh:Transformed on the card) against
    # the JAX package's transform.wrap(target).batch_logp, in float32: the
    # cores, and the interval's saturated tails (y = +-30, past sigmoid's
    # core 7.97; the exp family's tails, past 39.9, carry the eight-ulp
    # slack of tests/test_torch_transforms.py and stay out of a density
    # check)
    make, make_jax, table, jtable, d = TWIN_DENSITIES[name]
    make_jax = make_jax or _jax_mixture
    y = (2.0 * np.random.default_rng(d).standard_normal((512, d))).astype(
        np.float32)
    for i, bij in table.items():
        if bij.cuda[0] == T.BIJ_INTERVAL:
            y[:8, i] = [30.0, -30.0, 12.0, -12.0, 7.9, -7.9, 0.0, 20.0]
    w = CoordinateTransform(table, dim=d).wrap(make())
    got = _np(w.batch_logp(torch.from_numpy(y)))
    with jax.enable_x64(False):
        jw = J.CoordinateTransform(jtable, dim=d).wrap(make_jax())
        want = np.asarray(jw.batch_logp(jnp.asarray(y)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert w.cuda_transform is not None
    # inside the float32 saturation cores (where the float64 wrap is the
    # same function) the twin's float32 density misses float64's by no
    # more than density_rounding, what the GPU checks allow twice of
    tf = CoordinateTransform(table, dim=d)
    core = torch.from_numpy(np.abs(y) < 7.9).all(1)
    yt = torch.from_numpy(y)[core]
    err = (w.batch_logp(yt).double() - w.batch_logp(yt.double())).abs()
    assert (err <= tf.density_rounding(make(), yt)).all()
    assert len(w.cuda_params) == 6 + 3 * d + len(make().cuda_params)


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
