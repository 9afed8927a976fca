"""The ensemble stretch move in the port (``mini_mcmc_torch/ops/ensemble.py``,
``samplers.EnsembleSampler``) against the JAX package on the CPU.

One sweep on the JAX step's own draws (its key splits replayed: both
halves, the second against the updated first) equals JAX's ``step_fn`` at
rtol/atol 1e-5; affine equivariance holds draw for draw within the port;
the moments of ``tests/test_ensemble.py:29-70`` hold within 5 standard
errors; partners stay inside their ensemble; the constructor's checks,
``steps_per_call``, ``transform=`` and ``convert`` carry over. The JAX side
is pinned to float32 (``tests/conftest.py`` turns on x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    ensemble_sampler_kwargs,
    ensemble_state_from_numpy,
)
from mini_mcmc_torch.models import CoordinateTransform, Target, positive
from mini_mcmc_torch.ops.ensemble import (
    EnsembleState,
    HalfDraws,
    ensemble_kernel,
    ensemble_sweep,
)
from mini_mcmc_tpu import EnsembleSampler as JaxEnsemble
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.ensemble import EnsembleState as JaxState
from mini_mcmc_tpu.ops.ensemble import ensemble_kernel as jax_ensemble_kernel

torch.set_num_threads(1)

CPU = dict(device="cpu")
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _correlated3():
    """A correlated 3-D Gaussian in both packages, batch forms."""
    prec = np.linalg.inv(np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3],
                                   [0.0, -0.3, 0.5]])).astype(np.float32)
    pt, pj = torch.from_numpy(prec), jnp.asarray(prec)

    def logp(x):
        return -0.5 * torch.einsum("...i,ij,...j->...", x, pt, x)

    def jlogp(x):
        return -0.5 * jnp.einsum("...i,ij,...j->...", x, pj, x)

    return Target(logp=logp), jm.Target(logp=jlogp, logp_batch=jlogp)


@pytest.mark.parametrize("w, a", [(8, 2.0), (16, 1.6)])
def test_one_sweep_on_jax_draws(w, a):
    c, d = 64, 3
    t, jt = _correlated3()
    x = (1.3 * np.random.default_rng(w).standard_normal((c, d))).astype(
        np.float32)
    key = jax.random.PRNGKey(w + 1)
    e, h = c // w, w // 2
    with jax.enable_x64(False):
        _, step = jax_ensemble_kernel(jt, walkers_per_ensemble=w, a=a)
        want = step(JaxState(jnp.asarray(x), jt.batch_logp(jnp.asarray(x))),
                    key)
        halves = []
        for k in jax.random.split(key):  # the step's own splits
            k_j, k_z, k_u = jax.random.split(k, 3)
            halves.append(HalfDraws(*(torch.from_numpy(np.array(v)) for v in (
                jax.random.randint(k_j, (e, h), 0, h),
                jax.random.uniform(k_z, (e, h), jnp.float32),
                jax.random.uniform(k_u, (e, h), jnp.float32)))))
    halves[0] = halves[0]._replace(partner=halves[0].partner.long())
    halves[1] = halves[1]._replace(partner=halves[1].partner.long())
    xt = torch.from_numpy(x)
    got = ensemble_sweep(t, EnsembleState(xt, t.batch_logp(xt)), w, a,
                         *halves)
    np.testing.assert_allclose(_np(got.positions), np.asarray(want.positions),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got.logp), np.asarray(want.logp),
                               rtol=1e-5, atol=1e-5)
    moved = (_np(got.positions) != x).any(1).reshape(e, w)
    # both halves move, and some walkers stay
    assert moved[:, :h].any() and moved[:, h:].any() and not moved.all()


def test_affine_equivariance_draw_for_draw():
    # tests/test_ensemble.py:29-47 in float64: the same draws through an
    # affine map of target and ensemble give the mapped trajectory
    d = 3
    ell = torch.tensor([[2.0, 0.0, 0.0], [0.7, 0.5, 0.0], [-0.3, 1.2, 3.0]],
                       dtype=torch.float64)
    m = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    ell_inv = torch.linalg.inv(ell)
    t1 = Target(logp=lambda x: -0.5 * torch.sum(x * x, dim=-1))
    t2 = Target(logp=lambda y: -0.5 * torch.sum(
        ((y - m) @ ell_inv.T) ** 2, dim=-1))
    init = mt.init_with_seed(16, d, seed=0, dtype=torch.float64, **CPU)
    a = mt.EnsembleSampler(t1, init, **CPU).seed(9).run(200, 0)
    b = mt.EnsembleSampler(t2, init @ ell.T + m, **CPU).seed(9).run(200, 0)
    torch.testing.assert_close(b, a @ ell.T + m, rtol=1e-9, atol=1e-9)


def test_moments_correlated_gaussian():
    # tests/test_ensemble.py:50-67, within 5 standard errors
    es = mt.EnsembleSampler(mt.gaussian2d(MEAN, COV),
                            mt.init_with_seed(64, 2, seed=1, **CPU),
                            **CPU).seed(2)
    sample = es.run(4000, 1000)
    rhat, ess = mt.split_rhat_mean_ess(sample)
    assert float(rhat.max()) < 1.05 and float(ess.min()) > 500.0
    flat, ess = _np(sample).reshape(-1, 2).astype(np.float64), _np(ess)
    var = np.diag(COV)
    assert (np.abs(flat.mean(0) - MEAN) <= 5 * np.sqrt(var / ess)).all()
    assert (np.abs(flat.var(0) - var) <= 5 * var * np.sqrt(2 / ess)).all()
    cov01 = np.mean((flat[:, 0] - MEAN[0]) * (flat[:, 1] - MEAN[1]))
    assert abs(cov01 - 2.0) <= 5 * np.sqrt((4.0 * 3.0 + 2.0**2) / ess.min())


def test_ensembles_keep_their_partners_and_blocks_equal_steps():
    # tests/test_ensemble.py:70-88: two ensembles in two far wells
    target = Target(logp=lambda x: -50.0 * torch.sum(torch.minimum(
        (x - 10.0) ** 2, (x + 10.0) ** 2), dim=-1))
    noise = 0.2 * mt.init_with_seed(16, 1, seed=7, **CPU)
    init = torch.cat([10.0 + noise[:8], -10.0 + noise[8:]])
    s = mt.EnsembleSampler(target, init, walkers_per_ensemble=8,
                           **CPU).seed(3).run(300, 50)
    assert (s[:8] > 5.0).all() and (s[8:] < -5.0).all()
    assert (s[:, 1:] != s[:, :-1]).float().mean() > 0.3
    # K sweeps a block draw what K single sweeps draw: the same cube
    g = mt.gaussian2d(MEAN, COV)
    x0 = mt.init_with_seed(32, 2, seed=4, **CPU)
    one = mt.EnsembleSampler(g, x0, walkers_per_ensemble=8, **CPU).seed(5)
    blk = mt.EnsembleSampler(g, x0, walkers_per_ensemble=8, steps_per_call=4,
                             **CPU).seed(5)
    torch.testing.assert_close(one.run(32, 16), blk.run(32, 16), rtol=0,
                               atol=0)


def test_constructor_checks_transform_and_convert():
    g = mt.gaussian2d(MEAN, COV)
    x = mt.init_with_seed(16, 2, seed=1, **CPU)
    for kw, match in ((dict(walkers_per_ensemble=6), "multiple"),
                      (dict(walkers_per_ensemble=5), "even"),
                      (dict(a=1.0), "stretch scale"),
                      (dict(steps_per_call=0), "steps_per_call")):
        with pytest.raises(ValueError, match=match):
            mt.EnsembleSampler(g, x, **kw, **CPU)
    with pytest.raises(ValueError, match="D\\+2 = 6"):
        ensemble_kernel(mt.standard_normal(), walkers_per_ensemble=4)[0](
            torch.zeros(8, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.EnsembleSampler(g, np.zeros((8, 2), np.float32))
    # transform=: the move interpolates in y; the manual wrap bit for bit
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = tf.to_x(x)
    auto = mt.EnsembleSampler(g, x0, walkers_per_ensemble=8, transform=tf,
                              steps_per_call=2, **CPU).seed(4)
    manual = mt.EnsembleSampler(tf.wrap(g), tf.to_y(x0),
                                walkers_per_ensemble=8, steps_per_call=2,
                                **CPU).seed(4)
    torch.testing.assert_close(auto.run(20, 4), tf.to_x(manual.run(20, 4)),
                               rtol=0, atol=0)
    assert (auto.positions[:, 0] > 0).all()
    # a JAX sampler's settings and state carry across
    with jax.enable_x64(False):
        j = JaxEnsemble(jm.gaussian2d(MEAN, COV), jnp.asarray(_np(x)),
                        walkers_per_ensemble=8, a=1.7, steps_per_call=2)
        jstate = [np.array(v) for v in j.state]
    kw = ensemble_sampler_kwargs(j)
    assert kw == dict(walkers_per_ensemble=8, a=1.7, steps_per_call=2)
    s = mt.EnsembleSampler(g, torch.from_numpy(jstate[0]), **kw, **CPU)
    for a, b in zip(s.state, ensemble_state_from_numpy(*jstate, **CPU)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert s.run(4).shape == (16, 4, 2)
