"""ChEES-HMC in the port (``mini_mcmc_torch/ops/chees.py``,
``samplers.ChEESHMC``) against the JAX package on the CPU.

Deterministic parts on identical inputs: the Halton jitter bit for bit,
``_dynamic_leapfrog`` and the leapfrog count (its ``max_leapfrog`` cap
included) at rtol/atol 1e-5, the ChEES gradient at rtol 1e-4 (a NaN chain,
an all-diverged batch), and one jittered step on the JAX step's own draws
(its key splits replayed) at rtol/atol 1e-5. Statistical parity: the
moments of ``tests/test_chees.py:42-72`` within 5 standard errors, and
``warmed_up(200)``'s step size and trajectory length within 25% of the JAX
package's on the same target. The JAX side is pinned to float32
(``tests/conftest.py`` turns on x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import chees_sampler_kwargs, hmc_state_from_numpy
from mini_mcmc_torch.models import CoordinateTransform, positive
from mini_mcmc_torch.ops import chees as tc
from mini_mcmc_torch.ops.hmc import HMCState
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_tpu import ChEESHMC as JaxChEES
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops import chees as jc
from mini_mcmc_tpu.ops.hmc import HMCState as JaxHMCState

torch.set_num_threads(1)

CPU = dict(device="cpu")
WIDE = ([0.0, 0.0], [[1.0, 0.0], [0.0, 16.0]])  # tests/test_chees.py:23-26
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _targets():
    return mt.diffable_gaussian2d(*WIDE), jm.diffable_gaussian2d(*WIDE)


def _state(c, seed):
    """Positions, momenta and accept uniforms from numpy, and both
    packages' HMC states at those positions."""
    g = np.random.default_rng(seed)
    x = (g.standard_normal((c, 2)) * [1.0, 4.0]).astype(np.float32)
    t, jt = _targets()
    lp, gr = t.batch_logp_and_grad(torch.from_numpy(x))
    return (HMCState(torch.from_numpy(x), lp, gr),
            JaxHMCState(jnp.asarray(x), jnp.asarray(_np(lp)),
                        jnp.asarray(_np(gr))))


def test_halton_u_bit_for_bit():
    m = np.arange(1, 2**16 + 1)
    with jax.enable_x64(False):
        want = np.asarray(jax.vmap(jc.halton_u)(jnp.asarray(m, jnp.uint32)))
    got = _np(tc.halton_u(torch.from_numpy(m)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert float(tc.halton_u(3)) == 0.75 and float(tc.halton_u(8)) == 0.0625


@pytest.mark.parametrize("u, traj_len, eps, max_leapfrog", [
    (0.5, 2.0, 0.3, 1024), (0.999, 7.3, 0.01, 1024), (0.25, 1e6, 0.01, 16),
    (1e-6, 0.3, 0.3, 1024), (0.75, 0.3, 0.1, 1024), (0.5, 1.2, 0.3, 4)])
def test_leapfrog_count_and_dynamic_leapfrog_match_jax(u, traj_len, eps,
                                                       max_leapfrog):
    # the count in float32 as _jittered_step computes it, the cap included
    with jax.enable_x64(False):
        t32 = jnp.float32(u) * jnp.float32(traj_len)
        want_n = int(jnp.clip(jnp.ceil(t32 / jnp.float32(eps)).astype(
            jnp.int32), 1, max_leapfrog))
    n = tc.n_leapfrog(u, traj_len, eps, max_leapfrog)
    assert n == want_n
    state, jstate = _state(256, seed=n)
    t, jt = _targets()
    mom = np.random.default_rng(1).standard_normal((256, 2)).astype(
        np.float32)
    got = tc._dynamic_leapfrog(t, state.positions, torch.from_numpy(mom),
                               state.logp, state.grad, float(np.float32(eps)),
                               n)
    with jax.enable_x64(False):
        want = jc._dynamic_leapfrog(
            jt, jstate.positions, jnp.asarray(mom), jstate.logp, jstate.grad,
            jnp.float32(eps), jnp.int32(n))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_chees_gradient_matches_jax_with_nan_and_all_diverged():
    g = np.random.default_rng(5)
    c = 2048
    pos, prop, mom = (g.standard_normal((c, 2)).astype(np.float32)
                      for _ in range(3))
    alpha = g.uniform(0.0, 1.0, c).astype(np.float32)
    prop[7] = np.nan  # one divergent trajectory
    cases = [(alpha, 0.83), (np.zeros(c, np.float32), 0.83)]
    prop_all = np.full_like(prop, np.nan)  # every chain diverged
    for a, t in cases + [(alpha, 0.5)]:
        p = prop if t != 0.5 else prop_all
        got = float(tc.chees_grad_logT(*(torch.from_numpy(v) for v in (
            pos, p, mom, a)), t))
        with jax.enable_x64(False):
            want = float(jc._chees_grad_logT(
                *(jnp.asarray(v) for v in (pos, p, mom, a)), jnp.float32(t)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        if t == 0.5 or not a.any():
            assert got == want == 0.0


@pytest.mark.parametrize("u, traj_len, max_leapfrog", [
    (0.61, 9.1, 1024), (0.93, 40.0, 12)])
def test_one_jittered_step_on_jax_draws(u, traj_len, max_leapfrog):
    # the JAX step's own draws: its key split into (momentum, accept)
    c, eps = 512, 1.55  # near the fast coordinate's stability edge: rejects
    state, jstate = _state(c, seed=2)
    t, jt = _targets()
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(False):
        k_mom, k_u = jax.random.split(key)
        mom0 = np.array(jax.random.normal(k_mom, (c, 2), jnp.float32))
        u_acc = np.array(jax.random.uniform(k_u, (c,), jnp.float32))
        want = jc._jittered_step(jt, jstate, key, jnp.float32(eps),
                                 jnp.float32(traj_len), jnp.float32(u),
                                 max_leapfrog)
    n = tc.n_leapfrog(u, traj_len, eps, max_leapfrog)
    assert (n == max_leapfrog) == (max_leapfrog == 12)
    got = tc.jittered_step(t, state, float(np.float32(eps)), n,
                           torch.from_numpy(mom0), torch.from_numpy(u_acc))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    moved = (_np(got[0].positions) != _np(state.positions)).any(1)
    assert 0.05 < moved.mean() < 1.0


def _within(x, true_mean, true_var, ess, k=5.0):
    """Mean and variance within k standard errors (ESS-based)."""
    mean, var = x.mean(0), x.var(0)
    se_mean = np.sqrt(np.asarray(true_var) / ess)
    se_var = np.asarray(true_var) * np.sqrt(2.0 / ess)
    assert (np.abs(mean - true_mean) <= k * se_mean).all(), (mean, se_mean)
    assert (np.abs(var - true_var) <= k * se_var).all(), (var, se_var)


def test_warmup_grows_trajectory_and_samples_the_moments():
    # tests/test_chees.py:42-72: T grows toward the slow coordinate's
    # timescale, the tail acceptance near 0.651, moments within 5 SE
    ch = mt.ChEESHMC(mt.diffable_gaussian2d(*WIDE),
                     mt.init_with_seed(256, 2, seed=1, **CPU),
                     step_size=0.2, seed=3, **CPU)
    assert ch.traj_len == 0.2
    new = ch.warmed_up(300)
    assert 2.0 < new.traj_len < 40.0 and new.traj_len > 5 * ch.traj_len
    trace = new.warmup_trace
    assert all(trace[k].shape == (300,) for k in ("alpha", "traj_len", "eps"))
    assert 0.45 < float(trace["alpha"][-100:].mean()) < 0.85
    cube = new.run(500, 100)
    assert cube.shape == (256, 500, 2)
    rhat, ess = mt.split_rhat_mean_ess(cube)
    assert float(rhat.max()) < 1.05
    _within(_np(cube).reshape(-1, 2), [0.0, 0.0], [1.0, 16.0], _np(ess))


def test_warmed_up_matches_the_jax_adaptation():
    x0 = np.asarray(np.random.default_rng(0).standard_normal((256, 2)),
                    np.float32)
    port = mt.ChEESHMC(mt.diffable_gaussian2d(*WIDE), torch.from_numpy(x0),
                       step_size=0.2, seed=42, **CPU).warmed_up(200)
    with jax.enable_x64(False):
        jax_s = JaxChEES(jm.diffable_gaussian2d(*WIDE), jnp.asarray(x0),
                         step_size=0.2, seed=42).warmed_up(200)
    assert abs(port.step_size / jax_s.step_size - 1.0) < 0.25
    assert abs(port.traj_len / jax_s.traj_len - 1.0) < 0.25


def test_seeded_workflow_reproducible_and_run_reads_no_draw_from_device():
    def one():
        ch = mt.ChEESHMC(mt.diffable_gaussian2d(*WIDE),
                         mt.init_det(32, 2, **CPU), step_size=0.3, seed=9,
                         **CPU).warmed_up(60)
        return ch.step_size, ch.traj_len, ch.run(40, 0)

    a, b = one(), one()
    assert a[:2] == b[:2]
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    # the production jitter: Philox (chain 0, step, CHEES_U_DRAW) on the
    # host, the kernels' own unit map
    for seed, step in ((1, 0), (0xDEADBEEF12345, 77)):
        want = rng.uniform_at(torch.tensor(0), step, tc.CHEES_U_DRAW, seed)
        assert tc.production_u(seed, step) == float(want)


def test_kernel_contract_caps_and_refusals():
    t = mt.standard_normal()
    init_fn, step_fn = tc.chees_hmc_kernel(t, 0.5, 2.0)
    state = init_fn(mt.init_det(8, 3, **CPU))
    key = mt.ChEESHMC(t, mt.init_det(8, 3, **CPU), 0.5, **CPU)._next_key()
    out = step_fn(state, key)
    lp, g = t.batch_logp_and_grad(out.positions)
    torch.testing.assert_close(out.logp, lp)
    torch.testing.assert_close(out.grad, g)
    # a huge T at a tiny eps stops at max_leapfrog
    _, capped = tc.chees_hmc_kernel(t, 0.01, 1e6, max_leapfrog=16)
    assert torch.isfinite(capped(state, key).positions).all()
    for kw in (dict(step_size=0.0, traj_len=1.0),
               dict(step_size=0.1, traj_len=0.0)):
        with pytest.raises(ValueError):
            tc.chees_hmc_kernel(t, **kw)
    with pytest.raises(ValueError, match="n_adapt"):
        tc.chees_adapt(t, state, key, 0, 0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.ChEESHMC(t, np.zeros((8, 3), np.float32), 0.5)


def test_reconditioned_transform_and_convert():
    tw = mt.diffable_gaussian2d(*WIDE)
    ch = mt.ChEESHMC(tw, mt.init_with_seed(512, 2, seed=2, **CPU),
                     step_size=0.2, seed=5, **CPU).warmed_up(150)
    pre = ch.reconditioned("diag")
    scale = float(pre.metric.sigma_min())
    np.testing.assert_allclose(pre.step_size, ch.step_size / scale, rtol=1e-6)
    np.testing.assert_allclose(pre.traj_len, ch.traj_len / scale, rtol=1e-6)
    flat = _np(pre.warmed_up(100).run(200, 50)).reshape(-1, 2)
    np.testing.assert_allclose(flat.var(axis=0), [1.0, 16.0], rtol=0.3)
    # transform=: the manual wrap's chains bit for bit, samples natural
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = tf.to_x(mt.init_with_seed(32, 2, seed=4, **CPU))
    auto = mt.ChEESHMC(tw, x0, 0.3, 1.2, transform=tf, seed=8, **CPU)
    manual = mt.ChEESHMC(tf.wrap(tw), tf.to_y(x0), 0.3, 1.2, seed=8, **CPU)
    torch.testing.assert_close(auto.run(30, 10), tf.to_x(manual.run(30, 10)),
                               rtol=0, atol=0)
    warm = auto.warmed_up(30)
    assert warm.transform is tf and (warm.run(20)[..., 0] > 0).all()
    # a JAX sampler's settings and state carry across
    with jax.enable_x64(False):
        j = JaxChEES(jm.diffable_gaussian2d(*WIDE),
                     jnp.asarray(_np(x0)), 0.25, 1.5, max_leapfrog=64)
        jstate = [np.array(v) for v in j.state]
    kw = chees_sampler_kwargs(j)
    assert kw == dict(step_size=0.25, traj_len=1.5, max_leapfrog=64)
    s = mt.ChEESHMC(tw, torch.from_numpy(jstate[0]), **kw, **CPU)
    st = hmc_state_from_numpy(*jstate, **CPU)
    for a, b in zip(s.state, st):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
