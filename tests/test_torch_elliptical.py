"""Elliptical slice sampling in the port (``mini_mcmc_torch/ops/
elliptical.py``, ``samplers.EllipticalSliceSampler``) against the JAX
package on the CPU.

``_as_scale`` equals JAX's exactly in its three forms; one step at D = 8
with a full prior Cholesky on the JAX step's own draws (``split(key, 4)``,
each shrink iteration's split, the next angle drawn at the end of the
body) equals JAX's ``step_fn`` at rtol/atol 1e-5, whatever the host's test
interval; the analytic moments and the one-step KS test of
``tests/test_elliptical.py:44-135`` hold (moments within 5 standard
errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    elliptical_sampler_kwargs,
    elliptical_state_from_numpy,
)
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.ops.elliptical import (
    EllipticalDraws,
    EllipticalState,
    _as_scale,
    elliptical_step,
)
from mini_mcmc_tpu import EllipticalSliceSampler as JaxElliptical
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.elliptical import EllipticalState as JaxState
from mini_mcmc_tpu.ops.elliptical import _as_scale as jax_as_scale
from mini_mcmc_tpu.ops.elliptical import elliptical_kernel as jax_kernel

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _gauss_lik(mean, std):
    mean = torch.as_tensor(mean, dtype=torch.float32)
    return Target(logp=lambda x: -0.5 * torch.sum(((x - mean) / std) ** 2,
                                                  dim=-1))


def _chol(d, seed):
    g = np.random.default_rng(seed)
    a = g.standard_normal((d, d))
    return np.linalg.cholesky(a @ a.T / d + 0.5 * np.eye(d)).astype(
        np.float32)


def test_as_scale_matches_jax_exactly():
    d = 5
    for spec in (1.7, np.linspace(0.5, 2.0, d).astype(np.float32),
                 _chol(d, 1)):
        got = _np(_as_scale(torch.as_tensor(spec), d, torch.float32))
        with jax.enable_x64(False):
            want = np.asarray(jax_as_scale(jnp.asarray(spec), d, jnp.float32))
        np.testing.assert_array_equal(got, want)
    for bad, match in ((np.ones(3), "3 entries"),
                       (np.ones((4, 4)), "\\[5, 5\\]"),
                       (np.ones((5, 5, 1)), "scalar, \\[D\\], or \\[D, D\\]")):
        with pytest.raises(ValueError, match=match):
            _as_scale(torch.as_tensor(bad), d, torch.float32)


def test_one_step_on_jax_draws_any_test_interval():
    c, d, max_shrink = 512, 8, 32
    chol = _chol(d, 2)
    mu = np.linspace(-1.0, 1.0, d).astype(np.float32)
    y = np.random.default_rng(4).standard_normal(d).astype(np.float32)

    def loglik(x):  # a sharp likelihood: several shrinks a step
        return -0.5 * torch.sum(((x - torch.from_numpy(y)) / 0.3) ** 2, -1)

    def jloglik(x):
        return -0.5 * jnp.sum(((x - jnp.asarray(y)) / 0.3) ** 2, -1)

    x = (mu + np.random.default_rng(5).standard_normal((c, d)) @ chol.T * 0.3
         ).astype(np.float32)
    key = jax.random.PRNGKey(23)
    with jax.enable_x64(False):
        jt = jm.Target(logp=jloglik, logp_batch=jloglik)
        _, step = jax_kernel(jt, prior_mean=jnp.asarray(mu),
                             prior_scale=jnp.asarray(chol),
                             max_shrink=max_shrink)
        want = step(JaxState(jnp.asarray(x), jloglik(jnp.asarray(x))), key)
        k_nu, k_y, k_theta, k = jax.random.split(key, 4)
        shrink = []
        for _ in range(max_shrink):
            k, sub = jax.random.split(k)
            shrink.append(jax.random.uniform(sub, (c,), jnp.float32))
        draws = EllipticalDraws(*(torch.from_numpy(np.array(v)) for v in (
            jax.random.normal(k_nu, (c, d), jnp.float32),
            jax.random.uniform(k_y, (c,), jnp.float32),
            jax.random.uniform(k_theta, (c,), jnp.float32),
            jnp.stack(shrink))))
    t = Target(logp=loglik)
    xt = torch.from_numpy(x)
    outs = [elliptical_step(t, EllipticalState(xt, t.batch_logp(xt)),
                            torch.from_numpy(mu), torch.from_numpy(chol),
                            draws, every) for every in (1, 2, 5)]
    np.testing.assert_allclose(_np(outs[0].positions),
                               np.asarray(want.positions), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(outs[0].loglik), np.asarray(want.loglik),
                               rtol=1e-5, atol=1e-5)
    assert (_np(outs[0].positions) != x).any(1).mean() > 0.99
    for o in outs[1:]:
        torch.testing.assert_close(o.positions, outs[0].positions, rtol=0,
                                   atol=0)


def _within(flat, mean, var, ess, k=5.0):
    flat = flat.astype(np.float64)
    assert (np.abs(flat.mean(0) - mean) <= k * np.sqrt(var / ess)).all(), (
        flat.mean(0), ess)
    assert (np.abs(flat.var(0) - var) <= k * var * np.sqrt(2 / ess)).all(), (
        flat.var(0), ess)


def test_conjugate_moments_correlated_prior_and_prior_mean():
    # tests/test_elliptical.py:44-58: prior N(0, 4 I), likelihood N(m, I)
    sigma, s, m = 2.0, 1.0, np.array([1.0, -2.0])
    post_var = 1.0 / (1.0 / sigma**2 + 1.0 / s**2)
    es = mt.EllipticalSliceSampler(
        _gauss_lik(m, s), mt.init_with_seed(512, 2, seed=1, **CPU),
        prior_scale=sigma, steps_per_call=4, **CPU).seed(2)
    sample = es.run(160, 40)
    rhat, ess = mt.split_rhat_mean_ess(sample)
    assert float(rhat.max()) < 1.05
    _within(_np(sample).reshape(-1, 2), m / s**2 * post_var,
            np.full(2, post_var), _np(ess))
    # :60-72: a flat likelihood samples the correlated prior itself
    cov = np.array([[4.0, 2.0], [2.0, 3.0]])
    flat_lik = Target(logp=lambda x: torch.zeros(x.shape[:-1]))
    es = mt.EllipticalSliceSampler(
        flat_lik, mt.init_with_seed(512, 2, seed=2, **CPU),
        prior_scale=torch.linalg.cholesky(torch.tensor(cov,
                                                       dtype=torch.float32)),
        **CPU).seed(3)
    sample = es.run(160, 40)
    _, ess = mt.split_rhat_mean_ess(sample)
    flat = _np(sample).reshape(-1, 2)
    _within(flat, [0.0, 0.0], np.diag(cov), _np(ess))
    cov01 = np.mean(flat[:, 0] * flat[:, 1])
    assert abs(cov01 - 2.0) <= 5 * np.sqrt(16.0 / _np(ess).min())
    # :91-101: a prior mean and a scalar scale
    es = mt.EllipticalSliceSampler(
        flat_lik, mt.init_with_seed(512, 1, seed=3, **CPU), prior_mean=5.0,
        prior_scale=0.5, **CPU).seed(5)
    sample = es.run(120, 30)
    _, ess = mt.split_rhat_mean_ess(sample)
    _within(_np(sample).reshape(-1, 1), 5.0, np.array([0.25]), _np(ess))


def test_stationarity_one_step_ks():
    # tests/test_elliptical.py:74-89: an exact posterior sample stays so
    sigma, s, mval = 1.5, 0.8, 0.7
    prec = 1.0 / sigma**2 + 1.0 / s**2
    post_std, post_mean = prec**-0.5, (mval / s**2) / prec
    exact = torch.from_numpy((post_mean + post_std * np.random.default_rng(
        11).standard_normal((4096, 1))).astype(np.float32))
    es = mt.EllipticalSliceSampler(_gauss_lik([mval], s), exact,
                                   prior_scale=sigma, **CPU).seed(4)
    out = _np(es.run(1, 0))[:, 0, 0]
    assert sps.kstest(out, "norm", args=(post_mean, post_std)).pvalue > 0.01


def test_checks_blocks_and_convert():
    lik = _gauss_lik([0.0, 0.0], 1.0)
    x = mt.init_with_seed(16, 2, seed=8, **CPU)
    for kw, match in ((dict(max_shrink=0), "max_shrink"),
                      (dict(steps_per_call=0), "steps_per_call"),
                      (dict(prior_scale=[1.0, 2.0, 3.0]), "3 entries")):
        with pytest.raises(ValueError, match=match):
            mt.EllipticalSliceSampler(lik, x, **kw, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.EllipticalSliceSampler(lik, np.zeros((8, 2), np.float32))
    # K steps a block draw what K single steps draw
    one = mt.EllipticalSliceSampler(lik, x, prior_scale=[1.0, 2.0],
                                    **CPU).seed(9)
    blk = mt.EllipticalSliceSampler(lik, x, prior_scale=[1.0, 2.0],
                                    steps_per_call=4, **CPU).seed(9)
    torch.testing.assert_close(one.run(16, 8), blk.run(16, 8), rtol=0,
                               atol=0)
    # a JAX sampler's prior and settings carry across, its Cholesky exact
    chol = _chol(2, 3)
    with jax.enable_x64(False):
        jlik = jm.Target(logp=lambda z: -0.5 * jnp.sum(z * z))
        j = JaxElliptical(jlik, jnp.asarray(_np(x)), prior_mean=[1.0, 2.0],
                          prior_scale=jnp.asarray(chol), max_shrink=17,
                          steps_per_call=8)
        jstate = [np.array(v) for v in j.state]
    kw = elliptical_sampler_kwargs(j)
    np.testing.assert_array_equal(kw["prior_scale"], chol)
    assert kw["max_shrink"] == 17 and kw["steps_per_call"] == 8
    s = mt.EllipticalSliceSampler(_gauss_lik([0.0, 0.0], 1.0),
                                  torch.from_numpy(jstate[0]), **kw, **CPU)
    for a, b in zip(s.state, elliptical_state_from_numpy(*jstate, **CPU)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert s.run(8).shape == (16, 8, 2)
