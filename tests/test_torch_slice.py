"""The coordinate slice sampler in the port (``mini_mcmc_torch/ops/slice.py``,
``samplers.SliceSampler``) against the JAX package on the CPU.

One sweep at D = 3 with a per-coordinate width on the JAX step's own draws
(its key splits replayed: ``split(key, D)``, then per coordinate the
height, placement, stepping-out budget and each shrink iteration's split)
equals JAX's ``step_fn`` at rtol/atol 1e-5, and the result does not depend
on how often the host tests the loops. The moments and the one-sweep KS
test of ``tests/test_slice.py:38-115`` hold (moments within 5 standard
errors, at more chains and fewer sweeps than the JAX file, the lockstep
loops costing per sweep); ``width="auto"`` is the population std.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    slice_sampler_kwargs,
    slice_state_from_numpy,
)
from mini_mcmc_torch.models import CoordinateTransform, Target, positive
from mini_mcmc_torch.ops.slice import (
    CoordinateDraws,
    masked_loop,
    slice_update,
)
from mini_mcmc_tpu import SliceSampler as JaxSlice
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.slice import SliceState as JaxState
from mini_mcmc_tpu.ops.slice import slice_kernel as jax_slice_kernel

torch.set_num_threads(1)

CPU = dict(device="cpu")
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _correlated3():
    prec = np.linalg.inv(np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3],
                                   [0.0, -0.3, 0.5]])).astype(np.float32)
    pt, pj = torch.from_numpy(prec), jnp.asarray(prec)
    return (Target(logp=lambda x: -0.5 * torch.einsum("...i,ij,...j->...",
                                                      x, pt, x)),
            jm.Target(logp=lambda x: -0.5 * jnp.einsum("...i,ij,...j->...",
                                                       x, pj, x)))


def _jax_sweep_draws(key, c, d, max_stepouts, max_shrink):
    """The draws JAX's step_fn makes, coordinate by coordinate."""
    out = []
    for k in jax.random.split(key, d):
        k_y, k_u, k_j, k = jax.random.split(k, 4)
        shrink = []
        for _ in range(max_shrink):
            k, sub = jax.random.split(k)
            shrink.append(jax.random.uniform(sub, (c,), jnp.float32))
        out.append(CoordinateDraws(*(torch.from_numpy(np.array(v)) for v in (
            jax.random.uniform(k_y, (c,), jnp.float32),
            jax.random.uniform(k_u, (c,), jnp.float32),
            jax.random.randint(k_j, (c,), 0, max_stepouts),
            jnp.stack(shrink)))))
    return out


def test_one_sweep_on_jax_draws_any_test_interval():
    c, d, stepouts, shrink = 256, 3, 6, 32
    width = [0.5, 1.0, 2.5]
    t, jt = _correlated3()
    x = (1.2 * np.random.default_rng(3).standard_normal((c, d))).astype(
        np.float32)
    key = jax.random.PRNGKey(17)
    with jax.enable_x64(False):
        _, step = jax_slice_kernel(jt, width=jnp.asarray(width, jnp.float32),
                                   max_stepouts=stepouts, max_shrink=shrink)
        xj = jnp.asarray(x)
        want = step(JaxState(xj, jt.batch_logp(xj)), key)
        draws = _jax_sweep_draws(key, c, d, stepouts, shrink)
    results = []
    for every in (1, 2, 7):
        pos = torch.from_numpy(x)
        lp = t.batch_logp(pos)
        n0 = masked_loop.host_tests
        for i in range(d):
            dr = draws[i]._replace(left_budget=draws[i].left_budget.long())
            pos, lp = slice_update(t, pos, lp, i, float(np.float32(width[i])),
                                   dr, stepouts, every)
        results.append((pos, lp, masked_loop.host_tests - n0))
    np.testing.assert_allclose(_np(results[0][0]), np.asarray(want.positions),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(results[0][1]), np.asarray(want.logp),
                               rtol=1e-5, atol=1e-5)
    assert (_np(results[0][0]) != x).all(1).mean() > 0.9
    # the host's test interval changes the syncs, never the result
    for pos, lp, _ in results[1:]:
        torch.testing.assert_close(pos, results[0][0], rtol=0, atol=0)
        torch.testing.assert_close(lp, results[0][1], rtol=0, atol=0)
    assert results[0][2] > results[1][2] > results[2][2]


def test_stationarity_one_sweep_ks():
    # tests/test_slice.py:38-53: an exact N(0, 1) sample stays N(0, 1)
    # after one sweep, with the capped stepping out in play
    exact = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4096, 2)).astype(np.float32))
    ss = mt.SliceSampler(mt.standard_normal(), exact, width=0.5,
                         max_stepouts=4, **CPU).seed(3)
    out = _np(ss.run(1, 0))[:, 0, :]
    for d in range(2):
        assert sps.kstest(out[:, d], "norm").pvalue > 0.01


def _within(flat, mean, var, ess, kurtosis=3.0, k=5.0):
    """Mean and variance within k standard errors at the ESS: the
    variance's is ``var sqrt((kurtosis - 1) / ess)`` (3 for a normal, 9
    for an exponential)."""
    flat = flat.astype(np.float64)
    se_var = var * np.sqrt((kurtosis - 1.0) / ess)
    assert (np.abs(flat.mean(0) - mean) <= k * np.sqrt(var / ess)).all(), (
        flat.mean(0), ess)
    assert (np.abs(flat.var(0) - var) <= k * se_var).all(), (flat.var(0), ess)


def test_moments_correlated_gaussian_and_per_coordinate_width():
    # tests/test_slice.py:55-70 and :100-115
    ss = mt.SliceSampler(mt.gaussian2d(MEAN, COV),
                         mt.init_with_seed(512, 2, seed=1, **CPU),
                         steps_per_call=4, **CPU).seed(2)
    sample = ss.run(200, 40)
    rhat, ess = mt.split_rhat_mean_ess(sample)
    assert float(rhat.max()) < 1.05 and float(ess.min()) > 1000.0
    _within(_np(sample).reshape(-1, 2), MEAN, np.diag(COV), _np(ess))
    aniso = mt.SliceSampler(
        mt.gaussian2d([0.0, 0.0], [[0.01, 0.0], [0.0, 100.0]]),
        0.1 * mt.init_with_seed(512, 2, seed=4, **CPU),
        width=torch.tensor([0.1, 10.0]), **CPU).seed(6)
    sample = aniso.run(150, 30)
    _, ess = mt.split_rhat_mean_ess(sample)
    _within(_np(sample).reshape(-1, 2), [0.0, 0.0], np.array([0.01, 100.0]),
            _np(ess))


def test_hard_support_and_width_extremes():
    # tests/test_slice.py:72-98: -inf outside the support is never
    # accepted; both a tiny and a huge width sample N(0, 1)
    expo = Target(logp=lambda x: torch.where((x > 0.0).all(-1),
                                             -x.sum(-1), -torch.inf))
    init = torch.abs(mt.init_with_seed(512, 1, seed=2, **CPU)) + 0.1
    s = mt.SliceSampler(expo, init, **CPU).seed(4).run(150, 30)
    assert (s > 0.0).all()
    _, ess = mt.split_rhat_mean_ess(s)
    _within(_np(s).reshape(-1, 1), 1.0, np.array([1.0]), _np(ess),
            kurtosis=9.0)
    for width in (0.1, 50.0):
        s = mt.SliceSampler(mt.standard_normal(),
                            mt.init_with_seed(512, 1, seed=3, **CPU),
                            width=width, **CPU).seed(5).run(100, 20)
        _, ess = mt.split_rhat_mean_ess(s)
        _within(_np(s).reshape(-1, 1), 0.0, np.array([1.0]), _np(ess))


def test_auto_width_checks_transform_and_convert():
    g = mt.gaussian2d(MEAN, COV)
    x = mt.init_with_seed(64, 2, seed=1, **CPU)
    x[:, 1] = 3.0  # a degenerate coordinate falls back to width 1
    with jax.enable_x64(False):
        j = JaxSlice(jm.gaussian2d(MEAN, COV), jnp.asarray(_np(x)),
                     width="auto", max_stepouts=5, steps_per_call=2)
        jstate = [np.array(v) for v in j.state]
    auto = mt.SliceSampler(g, x, width="auto", **CPU)
    np.testing.assert_allclose(_np(auto.width), np.asarray(j.width),
                               rtol=1e-6)
    assert float(auto.width[1]) == 1.0
    np.testing.assert_allclose(float(auto.width[0]),
                               float(x[:, 0].std(correction=0)), rtol=1e-6)
    kw = slice_sampler_kwargs(j)
    assert kw["max_stepouts"] == 5 and kw["max_shrink"] == 32
    assert kw["steps_per_call"] == 2
    s = mt.SliceSampler(g, torch.from_numpy(jstate[0]), **kw, **CPU)
    for a, b in zip(s.state, slice_state_from_numpy(*jstate, **CPU)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert s.run(4).shape == (64, 4, 2)
    for kw, match in ((dict(width="wide"), '"auto"'),
                      (dict(width=0.0), "positive"),
                      (dict(width=[[1.0, 1.0]]), "scalar or \\[D\\]"),
                      (dict(max_stepouts=0), "max_stepouts"),
                      (dict(max_shrink=0), "max_shrink"),
                      (dict(steps_per_call=0), "steps_per_call")):
        with pytest.raises(ValueError, match=match):
            mt.SliceSampler(g, x, **kw, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.SliceSampler(g, np.zeros((8, 2), np.float32))
    # transform=: the bracket walks y; the manual wrap bit for bit, and
    # "auto" measures the spread there
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = tf.to_x(mt.init_with_seed(32, 2, seed=5, **CPU))
    a = mt.SliceSampler(g, x0, width="auto", transform=tf, **CPU).seed(2)
    m = mt.SliceSampler(tf.wrap(g), tf.to_y(x0), width="auto", **CPU).seed(2)
    torch.testing.assert_close(a.width, m.width, rtol=0, atol=0)
    torch.testing.assert_close(a.run(12, 4), tf.to_x(m.run(12, 4)), rtol=0,
                               atol=0)
    assert (a.positions[:, 0] > 0).all()
