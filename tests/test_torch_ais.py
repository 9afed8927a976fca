"""Annealed importance sampling in the port (``mini_mcmc_torch/ops/ais.py``)
against the JAX package on the CPU.

On the JAX functions' own draws (their key splits replayed): one
tempered-MH sweep and a one-rung anneal equal JAX's at rtol/atol 1e-6; a
16-rung anneal of 2,048 particles keeps positions and log weights within
1e-5 on at least 99.5% of particles (a float32 ulp of difference can flip
an accept near a tie, and the chain then differs) and ``log_z`` within
1e-4. ``linear_betas`` equals JAX's float32 schedule bit for bit. The
analytic pins of ``tests/test_ais.py`` hold with its tolerances. The JAX
side is pinned to float32 (``tests/conftest.py`` turns on x64).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.ops.ais import (
    _ais_result,
    _gaussian_prior,
    _make_tempered_mh,
    make_anneal,
    resample,
)
from mini_mcmc_tpu import ais_log_z as jax_ais_log_z
from mini_mcmc_tpu import linear_betas as jax_linear_betas
from mini_mcmc_tpu.models.base import Target as JaxTarget
from mini_mcmc_tpu.ops import ais as jais

torch.set_num_threads(1)

CPU = dict(device="cpu")
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _unnorm_gaussian(mean, std):
    """An unnormalized diagonal Gaussian in the port, as the JAX tests'."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)
    return Target(logp=lambda xs: -0.5 * torch.sum(((xs - mean) / std) ** 2,
                                                   dim=-1))


def _correlated():
    """bench.py's unnormalized correlated Gaussian2D in both packages."""
    prec = np.linalg.inv(np.array([[4.0, 2.0], [2.0, 3.0]])).astype(
        np.float32)
    pt, pj = torch.from_numpy(prec), jnp.asarray(prec)

    def jlogp(xs):
        return -0.5 * jnp.einsum("ni,ij,nj->n", xs, pj, xs)

    t = Target(logp=lambda xs: -0.5 * torch.einsum("ni,ij,nj->n", xs, pt,
                                                   xs))
    return t, JaxTarget(logp=lambda x: jlogp(x[None])[0], logp_batch=jlogp)


def _sweep_draws(key, n_mh, shape):
    """The proposal normals and accept uniforms the JAX sweep draws from
    ``key`` (ais.py:_make_tempered_mh's splits)."""
    normals, uniforms = [], []
    for sub in jax.random.split(key, n_mh):
        kp, ku = jax.random.split(sub)
        normals.append(np.asarray(jax.random.normal(kp, shape, jnp.float32)))
        uniforms.append(np.asarray(jax.random.uniform(ku, shape[:1],
                                                      jnp.float32)))
    return torch.from_numpy(np.stack(normals)), torch.from_numpy(
        np.stack(uniforms))


def _anneal_draws(rung_keys, n_mh, shape):
    draws = [_sweep_draws(k, n_mh, shape) for k in rung_keys]
    return (torch.stack([d[0] for d in draws]),
            torch.stack([d[1] for d in draws]))


@pytest.mark.parametrize("n", [1, 37, 64, 100, 128])
def test_linear_betas_bit_for_bit(n):
    with jax.enable_x64(False):
        want = np.asarray(jnp.linspace(0.0, 1.0, n + 1)[1:])
        want_fn = jax_linear_betas(n)
    got = np.asarray(mt.linear_betas(n), np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert mt.linear_betas(n) == want_fn
    assert mt.linear_betas(4) == (0.25, 0.5, 0.75, 1.0)


@pytest.mark.parametrize("n_mh, sigma, beta", [
    (1, 0.8, 0.37), (3, [1.0, 0.6], 0.9)])
def test_tempered_mh_sweep_on_jax_draws(n_mh, sigma, beta):
    n, d = 1024, 2
    t, jt = _correlated()
    x = (2.0 * np.random.default_rng(n_mh).standard_normal((n, d))).astype(
        np.float32)
    key = jax.random.PRNGKey(11 + n_mh)
    beta = float(np.float32(beta))
    with jax.enable_x64(False):
        _, _, jprior = jais._gaussian_prior(0.5, 2.5, d)
        sweeps = jais._make_tempered_mh(
            jt, jprior, jnp.atleast_1d(jnp.asarray(sigma, jnp.float32)),
            n_mh)
        xj = jnp.asarray(x)
        want = sweeps(xj, jt.batch_logp(xj), jprior(xj), jnp.float32(beta),
                      key)
        normals, uniforms = _sweep_draws(key, n_mh, (n, d))
        want_lp = (np.asarray(jt.batch_logp(xj)), np.asarray(jprior(xj)))
    _, _, prior = _gaussian_prior(0.5, 2.5, d, "cpu")
    sig = torch.tensor(sigma) if isinstance(sigma, list) else sigma
    xt = torch.from_numpy(x)
    lp_t, lp_p = t.batch_logp(xt), prior(xt)
    np.testing.assert_allclose(_np(lp_t), want_lp[0], **TOL)
    np.testing.assert_allclose(_np(lp_p), want_lp[1], **TOL)
    got = _make_tempered_mh(t, prior, sig)(xt, lp_t, lp_p, beta, normals,
                                           uniforms)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    moved = (_np(got[0]) != x).any(1).mean()
    assert 0.05 < moved < 1.0, moved  # some accept, some reject


def test_one_rung_on_jax_draws():
    # betas=(1.0,): the weight increment at the prior particle, then the
    # sweeps at beta = 1
    n, d = 1024, 2
    t, jt = _correlated()
    kw = dict(n_mh_steps=2, proposal_std=1.0, prior_std=2.5)
    x0 = (2.5 * np.random.default_rng(3).standard_normal((n, d))).astype(
        np.float32)
    rung_keys = jax.random.split(jax.random.PRNGKey(4), 1)
    with jax.enable_x64(False):
        want = jais.make_anneal(jt, (1.0,), **kw)(jnp.asarray(x0), rung_keys)
        normals, uniforms = _anneal_draws(rung_keys, 2, (n, d))
    got = make_anneal(t, (1.0,), **kw).on_draws(torch.from_numpy(x0),
                                                normals, uniforms)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_whole_anneal_on_jax_draws():
    # ais_log_z's own splits: the prior draw, then one key a rung
    n, d, k = 2048, 2, 16
    t, jt = _correlated()
    kw = dict(n_mh_steps=2, proposal_std=1.0, prior_std=2.5)
    with jax.enable_x64(False):
        want = jax_ais_log_z(jt, n, d, betas=k, seed=5, **kw)
        k_init, k_scan = jax.random.split(jax.random.PRNGKey(5))
        x0 = np.array(2.5 * jax.random.normal(k_init, (n, d), jnp.float32))
        normals, uniforms = _anneal_draws(jax.random.split(k_scan, k), 2,
                                          (n, d))
    anneal = make_anneal(t, mt.linear_betas(k), **kw)
    got = _ais_result(*anneal.on_draws(torch.from_numpy(x0), normals,
                                       uniforms))
    same = (np.abs(_np(got.positions) - np.asarray(want.positions))
            <= 1e-5 * (1 + np.abs(np.asarray(want.positions)))).all(1)
    same &= (np.abs(_np(got.log_weights) - np.asarray(want.log_weights))
             <= 1e-5 * (1 + np.abs(np.asarray(want.log_weights))))
    assert same.mean() >= 0.995, same.mean()
    assert abs(float(got.log_z) - float(want.log_z)) < 1e-4
    assert abs(float(got.weight_ess) - float(want.weight_ess)) < 1e-4


def test_log_z_pinned_to_analytic_gaussian():
    # tests/test_ais.py:29-42
    mean, std = [1.0, -2.0], [1.5, 0.5]
    true_log_z = float(np.sum(np.log(np.sqrt(2 * np.pi) * np.array(std))))
    r = mt.ais_log_z(_unnorm_gaussian(mean, std), 4096, 2, betas=128,
                     n_mh_steps=2, proposal_std=0.8, seed=0, **CPU)
    assert float(r.weight_ess) > 0.5, r.weight_ess
    assert abs(float(r.log_z) - true_log_z) < 0.05, (float(r.log_z),
                                                      true_log_z)
    pos = _np(r.positions)
    assert np.abs(pos.mean(axis=0) - np.asarray(mean)).max() < 0.15
    assert r.log_weights.shape == (4096,)


def test_schedule_invariance_of_the_mean():
    # tests/test_ais.py:45-57: E[w] = Z for any rung count
    t = _unnorm_gaussian([0.0], [2.0])
    true_log_z = float(np.log(np.sqrt(2 * np.pi) * 2.0))
    coarse = mt.ais_log_z(t, 8192, 1, betas=8, n_mh_steps=2,
                          proposal_std=1.0, seed=3, **CPU)
    fine = mt.ais_log_z(t, 8192, 1, betas=128, n_mh_steps=2,
                        proposal_std=1.0, seed=4, **CPU)
    assert abs(float(coarse.log_z) - true_log_z) < 0.1
    assert abs(float(fine.log_z) - true_log_z) < 0.05
    assert float(fine.weight_ess) > float(coarse.weight_ess)


def test_scaled_target_shifts_log_z_exactly():
    # tests/test_ais.py:60-74: exp(c) times the density shifts log Z by c
    base = _unnorm_gaussian([0.5], [1.0])
    shifted = Target(logp=lambda xs: base.batch_logp(xs) + 3.0)
    a = mt.ais_log_z(base, 2048, 1, betas=32, seed=7, **CPU)
    b = mt.ais_log_z(shifted, 2048, 1, betas=32, seed=7, **CPU)
    assert abs((float(b.log_z) - float(a.log_z)) - 3.0) < 0.1


def test_weight_ess_collapses_on_coarse_schedule():
    # tests/test_ais.py:77-82: one rung is plain importance sampling
    r = mt.ais_log_z(_unnorm_gaussian([6.0], [0.1]), 2048, 1, betas=1,
                     n_mh_steps=0, seed=1, **CPU)
    assert float(r.weight_ess) < 0.05, float(r.weight_ess)


def test_determinism_and_validation():
    # tests/test_ais.py:85-106, and the default device
    t = _unnorm_gaussian([0.0], [1.0])
    a = mt.ais_log_z(t, 256, 1, betas=16, seed=5, **CPU)
    b = mt.ais_log_z(t, 256, 1, betas=16, seed=5, **CPU)
    np.testing.assert_array_equal(_np(a.log_weights), _np(b.log_weights))
    c = mt.ais_log_z(t, 256, 1, betas=16, key=torch.Generator().manual_seed(
        5), **CPU)
    np.testing.assert_array_equal(_np(a.log_weights), _np(c.log_weights))
    assert a.positions.device.type == "cpu"
    with pytest.raises(ValueError, match="end at 1.0"):
        mt.ais_log_z(t, 256, 1, betas=(0.5, 0.9), **CPU)
    with pytest.raises(ValueError, match="increasing"):
        mt.ais_log_z(t, 256, 1, betas=(0.7, 0.3, 1.0), **CPU)
    with pytest.raises(ValueError, match="n_particles"):
        mt.ais_log_z(t, 1, 1, **CPU)
    with pytest.raises(ValueError, match="seed or key"):
        mt.ais_log_z(t, 256, 1, seed=1, key=torch.Generator(), **CPU)
    with pytest.raises(ValueError, match="prior_std"):
        mt.ais_log_z(t, 256, 1, prior_std=0.0, **CPU)
    with pytest.raises(ValueError, match="n_mh_steps"):
        make_anneal(t, (1.0,), n_mh_steps=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.ais_log_z(t, 256, 1)


def test_resample_matches_weighted_moments():
    # tests/test_ais.py:109-135
    r = mt.ais_log_z(_unnorm_gaussian([2.0], [0.7]), 8192, 1, betas=32,
                     n_mh_steps=2, seed=2, **CPU)
    log_w = _np(r.log_weights)
    w = np.exp(log_w - log_w.max())
    w = w / w.sum()
    weighted_mean = float(w @ _np(r.positions)[:, 0])
    draws = resample(r.log_weights, r.positions,
                     torch.Generator().manual_seed(0))
    assert draws.shape == (8192, 1)
    assert abs(float(draws.mean()) - weighted_mean) < 0.03
    assert abs(weighted_mean - 2.0) < 0.1
    # stratified: a dominant weight is replicated ~N*W_i times, +-1
    log_w = np.full(64, -np.inf, np.float32)
    log_w[[3, 40]] = np.log(0.75), np.log(0.25)
    pos = np.arange(64, dtype=np.float32)[:, None]
    d = _np(mt.resample(log_w, pos, torch.Generator().manual_seed(1)))
    assert abs(np.sum(d == 3.0) - 48) <= 1 and abs(np.sum(d == 40.0) - 16) <= 1
    gen = torch.Generator().manual_seed(2)
    assert mt.resample(log_w, pos, gen, n_draws=7).shape == (7, 1)
    with pytest.raises(ValueError, match="n_draws"):
        mt.resample(log_w, pos, gen, n_draws=0)


def test_bench_stage_at_small_size():
    # bench.py:1003-1043's target and settings at 8,192 particles: the
    # analytic log Z and the weight-ESS gate
    t, _ = _correlated()
    true_log_z = 0.5 * (2 * math.log(2 * math.pi)
                        + math.log(np.linalg.det([[4.0, 2.0], [2.0, 3.0]])))
    r = mt.ais_log_z(t, 8192, 2, betas=64, n_mh_steps=2, proposal_std=1.0,
                     prior_std=2.5, seed=0, **CPU)
    assert abs(float(r.log_z) - true_log_z) < 0.05
    assert float(r.weight_ess) > 0.3
