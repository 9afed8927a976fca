"""Adaptive SMC in the port (``mini_mcmc_torch/ops/smc.py``) against the JAX
package on the CPU.

One stage on the JAX run's own draws (its key splits replayed): the new
beta within 1e-6 of JAX's, the stage's ESS and log-Z increment within
1e-5, and the systematic resampling's indices equal except where JAX's
float32 cdf lies within 4e-7 of a stratum point (softmax and cumsum round
differently in the two frameworks), and differing at most at 0.5% of
the indices; the rejuvenated particles of equal indices within 1e-5 on
at least 99.5% of them. The analytic pins of ``tests/test_smc.py`` hold
with its tolerances, and a run reads the device once a stage. The JAX side
is pinned to float32 (``tests/conftest.py`` turns on x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.ops.ais import _systematic_indices
from mini_mcmc_torch.ops.smc import make_smc_run
from mini_mcmc_tpu.models.base import Target as JaxTarget
from mini_mcmc_tpu.ops import ais as jais
from mini_mcmc_tpu.ops import smc as jsmc

torch.set_num_threads(1)

CPU = dict(device="cpu")
#: how close JAX's cdf may come to a stratum point before the two
#: frameworks' float32 softmax and cumsum may pick neighbouring indices
TIE = 4e-7


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _unnorm_gaussian(mean, std):
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)
    return Target(logp=lambda xs: -0.5 * torch.sum(((xs - mean) / std) ** 2,
                                                   dim=-1))


def _jax_unnorm_gaussian(mean, std):
    mean = jnp.asarray(mean, jnp.float32)
    std = jnp.asarray(std, jnp.float32)

    def batch_logp(xs):
        return -0.5 * jnp.sum(((xs - mean) / std) ** 2, axis=-1)

    return JaxTarget(logp=lambda x: batch_logp(x[None])[0],
                     logp_batch=batch_logp)


def _near_ties(cdf, strata, idx):
    """Strata within TIE of JAX's cdf at the chosen index or the one
    before it: there the two frameworks' roundings may disagree."""
    n = cdf.shape[0]
    hi = cdf[np.minimum(idx, n - 1)]
    lo = np.where(idx > 0, cdf[np.maximum(idx - 1, 0)], -1.0)
    return (np.abs(hi - strata) <= TIE) | (np.abs(lo - strata) <= TIE)


def test_systematic_indices_on_identical_weights():
    # the same float32 log weights and uniform in both frameworks
    n = 65536
    log_w = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        u = np.asarray(jax.random.uniform(key, (), jnp.float32))
        want = np.asarray(jais._systematic_indices(jnp.asarray(log_w), key,
                                                   n, n))
        cdf = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(log_w))))
        strata = np.asarray((jnp.float32(u) + jnp.arange(n, dtype=jnp.float32))
                            / n)
    got = _np(_systematic_indices(torch.from_numpy(log_w), torch.tensor(u),
                                  n, n))
    near = _near_ties(cdf, strata, want)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (np.abs(got - want) <= 1).all()
    assert 0 < (got != want).mean() <= 0.005, (got != want).mean()


def test_one_stage_on_jax_draws():
    n, d, n_mh = 4096, 2, 3
    kw = dict(n_mh_steps=n_mh, proposal_std=0.8, target_ess=0.5)
    mean, std = [2.0, 0.0], [1.0, 2.0]
    x0 = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    k_loop = jax.random.PRNGKey(7)
    with jax.enable_x64(False):
        jt = _jax_unnorm_gaussian(mean, std)
        xj, beta_j, log_z_j, j, betas_j, ess_j = jsmc.make_smc_run(
            jt, max_stages=1, **kw)(jnp.asarray(x0), k_loop)
        # the stage's splits (smc.py:119) and its draws
        _, k_res, k_mh = jax.random.split(k_loop, 3)
        u = float(jax.random.uniform(k_res, (), jnp.float32))
        normals, uniforms = [], []
        for sub in jax.random.split(k_mh, n_mh):
            kp, ku = jax.random.split(sub)
            normals.append(np.asarray(jax.random.normal(kp, (n, d),
                                                        jnp.float32)))
            uniforms.append(np.asarray(jax.random.uniform(ku, (n,),
                                                          jnp.float32)))
        # JAX's indices, cdf and strata from its own new beta
        _, _, jprior = jais._gaussian_prior(0.0, 1.0, d)
        x0j = jnp.asarray(x0)
        dw = beta_j * (jt.batch_logp(x0j) - jprior(x0j))
        idx_j = np.asarray(jais._systematic_indices(dw, k_res, n, n))
        cdf = np.asarray(jnp.cumsum(jax.nn.softmax(dw)))
        strata = np.asarray((jnp.float32(u) + jnp.arange(n, dtype=jnp.float32))
                            / n)
    assert int(j) == 1 and float(beta_j) < 1.0  # the stage bisected
    t = _unnorm_gaussian(mean, std)
    run = make_smc_run(t, **kw)
    xt = torch.from_numpy(x0)
    _, _, prior = mt.ops.ais._gaussian_prior(0.0, 1.0, d, "cpu")
    s = run.stage(xt, t.batch_logp(xt), prior(xt), 0.0, torch.tensor(u),
                  torch.from_numpy(np.stack(normals)),
                  torch.from_numpy(np.stack(uniforms)))
    assert abs(float(s.beta) - float(beta_j)) <= 1e-6
    assert abs(float(s.ess) - float(ess_j[0])) <= 1e-5
    assert abs(float(s.log_z_increment) - float(log_z_j)) <= 1e-5
    assert not bool(s.stalled)
    idx = _np(s.idx)
    near = _near_ties(cdf, strata, idx_j)
    np.testing.assert_array_equal(idx[~near], idx_j[~near])
    same = idx == idx_j
    assert same.mean() >= 0.995, same.mean()
    xs, xw = _np(s.x)[same], np.asarray(xj)[same]
    ok = (np.abs(xs - xw) <= 1e-5 * (1 + np.abs(xw))).all(1)
    assert ok.mean() >= 0.995, ok.mean()


def test_log_z_pinned_to_analytic_gaussian():
    # tests/test_smc.py:29-39
    mean, std = [1.0, -2.0], [1.5, 0.5]
    true_log_z = float(np.sum(np.log(np.sqrt(2 * np.pi) * np.array(std))))
    r = mt.smc_log_z(_unnorm_gaussian(mean, std), 8192, 2, n_mh_steps=3,
                     proposal_std=0.8, seed=0, **CPU)
    assert abs(float(r.log_z) - true_log_z) < 0.05, (float(r.log_z),
                                                      true_log_z)
    pos = _np(r.positions)
    assert np.abs(pos.mean(axis=0) - np.asarray(mean)).max() < 0.15
    assert np.abs(pos.std(axis=0) - np.asarray(std)).max() < 0.15


def test_adaptive_schedule_properties():
    # tests/test_smc.py:42-69, and one device read a stage
    easy = mt.smc_log_z(_unnorm_gaussian([0.0], [1.0]), 4096, 1,
                        target_ess=0.5, seed=1, **CPU)
    hard = mt.smc_log_z(_unnorm_gaussian([4.0], [0.5]), 4096, 1,
                        target_ess=0.5, n_mh_steps=8, seed=1, **CPU)
    for r in (easy, hard):
        b = _np(r.betas)
        assert b.shape == (r.n_stages,)
        assert np.all(np.diff(np.concatenate([[0.0], b])) > 0)
        assert b[-1] == 1.0
        ess = _np(r.stage_ess)
        if r.n_stages > 1:
            np.testing.assert_allclose(ess[:-1], 0.5, atol=0.02)
        assert np.all(ess >= 0.45)
    assert hard.n_stages > easy.n_stages
    true_hard = float(np.log(np.sqrt(2 * np.pi) * 0.5))
    assert abs(float(hard.log_z) - true_hard) < 0.15
    run = make_smc_run(_unnorm_gaussian([4.0], [0.5]), target_ess=0.5,
                       n_mh_steps=8)
    out = run(torch.randn((4096, 1), generator=torch.Generator(
        ).manual_seed(2)), torch.Generator().manual_seed(3))
    assert float(out[1]) == 1.0 and run.host_reads == out[3] > 1


def test_agrees_with_ais_on_shared_target():
    # tests/test_smc.py:72-83
    t = _unnorm_gaussian([2.0, 0.0], [1.0, 2.0])
    true_log_z = float(np.sum(np.log(np.sqrt(2 * np.pi)
                                     * np.asarray([1.0, 2.0]))))
    a = mt.ais_log_z(t, 8192, 2, betas=64, n_mh_steps=2, seed=3, **CPU)
    s = mt.smc_log_z(t, 8192, 2, n_mh_steps=2, seed=3, **CPU)
    assert abs(float(a.log_z) - true_log_z) < 0.1
    assert abs(float(s.log_z) - true_log_z) < 0.1
    assert abs(float(a.log_z) - float(s.log_z)) < 0.15


def test_truncated_anneal_raises():
    # tests/test_smc.py:86-91: a truncated anneal raises, not returns
    with pytest.raises(RuntimeError, match="max_stages"):
        mt.smc_log_z(_unnorm_gaussian([7.0], [0.1]), 1024, 1,
                     target_ess=0.9, max_stages=3, seed=2, **CPU)


def test_determinism_and_validation():
    # tests/test_smc.py:94-108, and the default device
    t = _unnorm_gaussian([0.0], [1.0])
    a = mt.smc_log_z(t, 512, 1, seed=5, **CPU)
    b = mt.smc_log_z(t, 512, 1, seed=5, **CPU)
    assert float(a.log_z) == float(b.log_z)
    np.testing.assert_array_equal(_np(a.positions), _np(b.positions))
    assert a.positions.device.type == "cpu"
    with pytest.raises(ValueError, match="target_ess"):
        mt.smc_log_z(t, 512, 1, target_ess=1.0, **CPU)
    with pytest.raises(ValueError, match="n_particles"):
        mt.smc_log_z(t, 1, 1, **CPU)
    with pytest.raises(ValueError, match="seed or key"):
        mt.smc_log_z(t, 512, 1, seed=1, key=torch.Generator(), **CPU)
    with pytest.raises(ValueError, match="max_stages"):
        make_smc_run(t, max_stages=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.smc_log_z(t, 512, 1)
