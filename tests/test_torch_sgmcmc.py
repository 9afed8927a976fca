"""SG-MCMC in the port (``mini_mcmc_torch/ops/sgmcmc.py``, ``SGLD``,
``SGHMC``) against the JAX package on the CPU.

On the JAX steps' own draws (their key splits replayed: the batch indices
and the normals): an SGLD step, a pSGLD step (the first, debiased one and
a later one) and an SGHMC step equal JAX's at rtol/atol 1e-6, and
``minibatch_grad`` on given indices equals JAX's at 1e-5 with a shared
batch, with a batch per chain and on tuple data. ``polynomial_decay``
equals JAX's float32 schedule over steps 0..10^5 within 1e-7 relative.
The tests of ``tests/test_sgmcmc.py`` hold with its tolerances (but the
checkpoint round trip, which waits for the port's ``checkpoint.py``), and
``steps_per_call`` gives the one-step cube bit for bit. The JAX side is
pinned to float32 (``tests/conftest.py`` turns on x64).
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    data_from_numpy,
    sghmc_sampler_kwargs,
    sghmc_state_from_numpy,
    sgld_sampler_kwargs,
    sgld_state_from_numpy,
)
from mini_mcmc_torch.ops.sgmcmc import (
    SGHMCState,
    SGLDState,
    sghmc_update,
    sgld_update,
)
from mini_mcmc_tpu import SGHMC as JaxSGHMC
from mini_mcmc_tpu import SGLD as JaxSGLD
from mini_mcmc_tpu.ops import sgmcmc as jsg

torch.set_num_threads(1)

CPU = dict(device="cpu")
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _regression(n=512, d=4, seed=0):
    """A Bayesian linear regression's rows (float32) and its minibatch
    log prior and likelihood in both packages."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    y = (x @ np.linspace(-1.0, 1.0, d) + 0.5 * rng.standard_normal(n)
         ).astype(np.float32)

    def prior(w, s=torch):
        return -0.5 * s.sum(w * w) / 4.0

    def like(w, batch, s=torch):
        return -0.5 * s.sum((batch[1] - batch[0] @ w) ** 2) / 0.25

    return (x, y), prior, like, (lambda w: prior(w, jnp)), (
        lambda w, b: like(w, b, jnp))


def _grad_fns(batch_size, shared=True):
    data, prior, like, jprior, jlike = _regression()
    port = mt.minibatch_grad(prior, like, data, batch_size,
                             shared_batch=shared, **CPU)
    with jax.enable_x64(False):
        jax_fn = jsg.minibatch_grad(jprior, jlike, tuple(map(jnp.asarray,
                                                             data)),
                                    batch_size, shared_batch=shared)
    return port, jax_fn, data[0].shape[0]


def _conjugate_problem(seed=0, n=512, dim=2, sigma0=1.0):
    """tests/test_sgmcmc.py:27-45 in float32 rows: y_i ~ N(x, I), prior
    x ~ N(0, sigma0^2 I), the exact Gaussian posterior in float64."""
    rng = np.random.default_rng(seed)
    x_true = rng.normal(size=(dim,))
    y = x_true + rng.normal(size=(n, dim))
    prec = n + 1.0 / sigma0**2
    post_mean = y.sum(axis=0) / prec

    def log_prior(x):
        return -0.5 * torch.sum(x**2) / sigma0**2

    def log_like(x, batch):
        return -0.5 * torch.sum((batch - x) ** 2)

    return (log_prior, log_like, torch.from_numpy(y.astype(np.float32)),
            post_mean, 1.0 / prec)


@pytest.mark.parametrize("a, b, gamma", [
    (2e-6, 50.0, 0.33), (1e-6, 50.0, 0.33), (0.05, 10.0, 0.55)])
def test_polynomial_decay_matches_jax(a, b, gamma):
    steps = np.arange(100001)
    with jax.enable_x64(False):
        want = np.asarray(jsg.polynomial_decay(a, b, gamma)(
            jnp.asarray(steps, jnp.int32)))
    sched = mt.polynomial_decay(a, b, gamma)
    got = np.array([sched(int(t)) for t in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert (sched.a, sched.b, sched.gamma) == (a, b, gamma)
    with pytest.raises(ValueError, match="gamma"):
        mt.polynomial_decay(a, b, -0.1)


@pytest.mark.parametrize("shared, tuple_data", [
    (True, True), (False, True), (True, False), (False, False)])
def test_minibatch_grad_on_jax_indices(shared, tuple_data):
    c, bsz = 16, 64
    key = jax.random.PRNGKey(3)
    w = np.random.default_rng(1).standard_normal((c, 4)).astype(np.float32)
    if tuple_data:
        port, jax_fn, n = _grad_fns(bsz, shared)
    else:  # one [N, D] array: the conjugate problem's
        log_prior, log_like, y, _, _ = _conjugate_problem(dim=4)
        port = mt.minibatch_grad(log_prior, log_like, y, bsz,
                                 shared_batch=shared, **CPU)
        with jax.enable_x64(False):
            jax_fn = jsg.minibatch_grad(
                lambda x: -0.5 * jnp.sum(x**2),
                lambda x, b: -0.5 * jnp.sum((b - x) ** 2),
                jnp.asarray(_np(y)), bsz, shared_batch=shared)
        n = y.shape[0]
    with jax.enable_x64(False):
        want = np.asarray(jax_fn(jnp.asarray(w), key))
        idx = np.array(jax.random.randint(
            key, (bsz,) if shared else (c, bsz), 0, n))
    got = port.on_indices(torch.from_numpy(w), torch.from_numpy(idx).long())
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def _jax_step_inputs(key, x, bsz=64, n=512):
    """The JAX step's batch indices and normals (sgmcmc.py:384-389)."""
    k_batch, k_noise = jax.random.split(key)
    idx = jax.random.randint(k_batch, (bsz,), 0, n)
    xi = jax.random.normal(k_noise, x.shape, jnp.float32)
    return torch.from_numpy(np.array(idx)).long(), torch.from_numpy(
        np.array(xi))


@pytest.mark.parametrize("precond, step, sched", [
    (None, 0, None), (None, 1000, (2e-6, 50.0, 0.33)),
    ("rmsprop", 0, None), ("rmsprop", 7, (1e-4, 50.0, 0.33))])
def test_sgld_step_on_jax_draws(precond, step, sched):
    c, d = 64, 4
    port, jax_fn, _ = _grad_fns(64)
    rng = np.random.default_rng(step + 1)
    x = rng.standard_normal((c, d)).astype(np.float32)
    sq = (0.0 if step == 0 and precond else
          np.abs(rng.standard_normal((c, d))).astype(np.float32) * 100.0)
    if precond is None:
        sq = np.float32(0.0)
    kw = dict(temperature=0.7, preconditioner=precond, rms_decay=0.9999,
              rms_eps=1e-5)
    eps = 3e-5 if sched is None else sched
    key = jax.random.PRNGKey(step)
    with jax.enable_x64(False):
        _, step_fn = jsg.sgld_kernel(
            jax_fn, eps if sched is None else jsg.polynomial_decay(*sched),
            **kw)
        sq_j = jnp.broadcast_to(jnp.float32(sq), (c, d)) if precond \
            else jnp.float32(sq)
        want = step_fn(jsg.SGLDState(jnp.asarray(x), sq_j, jnp.int32(step)),
                       key)
        idx, xi = _jax_step_inputs(key, x)
    xt = torch.from_numpy(x)
    sq_t = torch.from_numpy(np.array(np.broadcast_to(sq, (c, d)) if precond
                                     else sq, np.float32))
    eps_t = (mt.polynomial_decay(*sched)(step) if sched
             else float(np.float32(eps)))
    got = sgld_update(SGLDState(xt, sq_t, step), port.on_indices(xt, idx),
                      xi, eps_t, **kw)
    np.testing.assert_allclose(_np(got.positions), np.asarray(
        want.positions), **TOL)
    np.testing.assert_allclose(_np(got.sq_avg), np.asarray(want.sq_avg),
                               **TOL)
    assert got.step == int(want.step) == step + 1


def test_sghmc_step_on_jax_draws():
    c, d, step = 64, 4, 3
    port, jax_fn, _ = _grad_fns(64)
    rng = np.random.default_rng(5)
    x, v = (rng.standard_normal((c, d)).astype(np.float32) for _ in range(2))
    v *= 1e-3
    key = jax.random.PRNGKey(9)
    sched = (1e-6, 50.0, 0.33)
    with jax.enable_x64(False):
        _, step_fn = jsg.sghmc_kernel(jax_fn, jsg.polynomial_decay(*sched),
                                      friction=0.5, temperature=1.3)
        want = step_fn(jsg.SGHMCState(jnp.asarray(x), jnp.asarray(v),
                                      jnp.int32(step)), key)
        idx, xi = _jax_step_inputs(key, x)
    xt = torch.from_numpy(x)
    got = sghmc_update(SGHMCState(xt, torch.from_numpy(v), step),
                       port.on_indices(xt, idx), xi,
                       mt.polynomial_decay(*sched)(step), friction=0.5,
                       temperature=1.3)
    np.testing.assert_allclose(_np(got.positions), np.asarray(
        want.positions), **TOL)
    np.testing.assert_allclose(_np(got.momenta), np.asarray(want.momenta),
                               **TOL)
    assert got.step == step + 1


# -- estimator (tests/test_sgmcmc.py:51-118) ----------------------------------


@pytest.mark.parametrize("shared", [True, False])
def test_minibatch_grad_is_unbiased(shared):
    log_prior, log_like, data, _, _ = _conjugate_problem()
    n = data.shape[0]
    grad_fn = mt.minibatch_grad(log_prior, log_like, data, batch_size=32,
                                shared_batch=shared, **CPU)
    x = torch.tensor([[0.3, -0.7], [1.0, 0.0]])
    exact = -x + (data.sum(0, dtype=torch.float64)[None, :].float() - n * x)
    gen = torch.Generator().manual_seed(0 if shared else 1)
    est = torch.stack([grad_fn(x, gen) for _ in range(4000)]).mean(0)
    np.testing.assert_allclose(_np(est), _np(exact), atol=3.0, rtol=0.02)


def test_minibatch_grad_pytree_data_and_device():
    # an (X, y) tuple with a matmul likelihood, a list, and a dict
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(128, 3)).astype(np.float32)
    ys = rng.normal(size=(128,)).astype(np.float32)

    def log_like(w, batch):
        bx, by = batch
        return -0.5 * torch.sum((by - bx @ w) ** 2)

    for data, like in (((xs, ys), log_like), ([xs, ys], log_like),
                       ({"x": xs, "y": ys},
                        lambda w, b: log_like(w, (b["x"], b["y"])))):
        grad_fn = mt.minibatch_grad(lambda w: -0.5 * torch.sum(w**2), like,
                                    data, batch_size=16, **CPU)
        g = grad_fn(torch.zeros(4, 3), torch.Generator().manual_seed(0))
        assert g.shape == (4, 3) and bool(torch.isfinite(g).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.minibatch_grad(lambda w: 0.0, log_like, (xs, ys), 16)


def test_target_grad_matches_target():
    target = mt.diffable_gaussian2d([0.0, 1.0], [[2.0, 0.5], [0.5, 1.0]])
    x = torch.tensor([[0.2, -0.4], [1.5, 2.0]])
    _, exact = target.batch_logp_and_grad(x)
    np.testing.assert_allclose(_np(mt.target_grad(target)(x, None)),
                               _np(exact))


def test_minibatch_grad_validation():
    data = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="batch_size"):
        mt.minibatch_grad(lambda x: 0.0, lambda x, b: 0.0, data,
                          batch_size=9, **CPU)
    with pytest.raises(ValueError, match="leading axis"):
        mt.minibatch_grad(lambda x: 0.0, lambda x, b: 0.0,
                          (torch.zeros((8, 2)), torch.zeros((7,))),
                          batch_size=4, **CPU)
    with pytest.raises(ValueError, match="at least one"):
        mt.minibatch_grad(lambda x: 0.0, lambda x, b: 0.0, (), 1, **CPU)


# -- SGLD (tests/test_sgmcmc.py:124-248) --------------------------------------


def _std_normal_grad():
    return mt.target_grad(mt.standard_normal())


def _init(c, d):
    return mt.init_det(c, d, **CPU)


def test_sgld_shapes_and_reproducibility():
    g = _std_normal_grad()
    a = mt.SGLD(g, _init(4, 3), step_size=0.01, seed=5, **CPU).run(50, 10)
    b = mt.SGLD(g, _init(4, 3), step_size=0.01, seed=5, **CPU).run(50, 10)
    assert a.shape == (4, 50, 3)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_sgld_full_batch_gaussian_moments():
    # unadjusted Langevin on N(0, I): stationary variance 1/(1 - eps/4)
    sgld = mt.SGLD(_std_normal_grad(), _init(32, 2), step_size=0.05,
                   seed=42, **CPU)
    flat = _np(sgld.run(4000, 500)).reshape(-1, 2)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.08), flat.mean(axis=0)
    assert np.all(np.abs(flat.var(axis=0) - 1.0) < 0.12), flat.var(axis=0)


def test_sgld_minibatch_conjugate_posterior():
    log_prior, log_like, data, post_mean, post_var = _conjugate_problem()
    grad_fn = mt.minibatch_grad(log_prior, log_like, data, batch_size=64,
                                **CPU)
    init = torch.tensor(post_mean, dtype=torch.float32)[None].repeat(8, 1)
    sgld = mt.SGLD(grad_fn, init, step_size=5e-4, seed=7, **CPU)
    flat = _np(sgld.run(3000, 1000)).reshape(-1, 2)
    post_std = np.sqrt(post_var)
    assert np.all(np.abs(flat.mean(axis=0) - post_mean) < 3 * post_std), (
        flat.mean(axis=0), post_mean)
    assert np.all(flat.var(axis=0) < 4.0 * post_var), (flat.var(axis=0),
                                                       post_var)
    assert np.all(flat.var(axis=0) > 0.5 * post_var)


def test_psgld_equalizes_anisotropic_scales():
    # N(0, diag(1, 100)): one shared step size samples both coordinates
    sigma2 = torch.tensor([1.0, 100.0])

    def grad_fn(x, key):
        del key
        return -x / sigma2[None, :]

    sgld = mt.SGLD(grad_fn, _init(16, 2), step_size=0.02, seed=9,
                   preconditioner="rmsprop", rms_decay=0.999, **CPU)
    var = _np(sgld.run(6000, 2000)).reshape(-1, 2).var(axis=0)
    assert abs(var[0] - 1.0) < 0.3, var
    assert abs(var[1] - 100.0) < 30.0, var
    assert 70.0 < var[1] / var[0] < 140.0, var
    # negative control: plain SGLD at the same step size is still far from
    # the sigma=10 coordinate's scale in this budget
    plain = mt.SGLD(grad_fn, _init(16, 2), step_size=0.02, seed=9, **CPU)
    var_p = _np(plain.run(6000, 2000)).reshape(-1, 2).var(axis=0)
    assert var_p[1] < 65.0, var_p


def test_sgld_schedule_decays_on_the_host():
    sched = mt.polynomial_decay(0.05, 10.0, 0.55)
    assert sched(0) > sched(1000)
    sgld = mt.SGLD(_std_normal_grad(), _init(4, 2), step_size=sched, seed=3,
                   **CPU)
    sgld.run(20, 5)
    assert sgld.state.step == 25


def test_sgld_temperature_zero_is_gradient_ascent():
    sgld = mt.SGLD(_std_normal_grad(), 5.0 * torch.ones((4, 2)),
                   step_size=0.1, seed=0, temperature=0.0, **CPU)
    sgld.run(200, 0)
    assert np.all(np.abs(_np(sgld.positions)) < 1e-3)


@pytest.mark.parametrize("kind", ["sgld", "psgld", "sghmc"])
def test_steps_per_call_equals_single_steps(kind):
    # K steps a block draw what K single steps draw: the same cube
    g = _std_normal_grad()

    def make(k):
        if kind == "sghmc":
            return mt.SGHMC(g, _init(4, 2), step_size=0.05, seed=11,
                            steps_per_call=k, **CPU)
        return mt.SGLD(g, _init(4, 2), step_size=0.05, seed=11,
                       preconditioner="rmsprop" if kind == "psgld" else None,
                       steps_per_call=k, **CPU)

    s = make(8)
    a = s.run(48, 16)
    assert a.shape == (4, 48, 2)
    np.testing.assert_array_equal(_np(a), _np(make(8).run(48, 16)))
    np.testing.assert_array_equal(_np(a), _np(make(1).run(48, 16)))
    with pytest.raises(ValueError, match="multiples"):
        s.run(10, 0)


def test_sgld_validation():
    g = _std_normal_grad()
    with pytest.raises(ValueError, match="preconditioner"):
        mt.SGLD(g, _init(2, 2), step_size=0.01, preconditioner="adam", **CPU)
    with pytest.raises(ValueError, match="step_size"):
        mt.SGLD(g, _init(2, 2), step_size=-1.0, **CPU)
    with pytest.raises(ValueError, match="temperature"):
        mt.SGLD(g, _init(2, 2), step_size=0.01, temperature=-0.5, **CPU)
    with pytest.raises(ValueError, match="steps_per_call"):
        mt.SGLD(g, _init(2, 2), step_size=0.01, steps_per_call=0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.SGLD(g, np.zeros((2, 2), np.float32), step_size=0.01)


# -- SGHMC (tests/test_sgmcmc.py:254-291) -------------------------------------


def test_sghmc_shapes_and_reproducibility():
    g = _std_normal_grad()
    a = mt.SGHMC(g, _init(4, 3), step_size=0.05, seed=5, **CPU).run(50, 50)
    b = mt.SGHMC(g, _init(4, 3), step_size=0.05, seed=5, **CPU).run(50, 50)
    assert a.shape == (4, 50, 3)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_sghmc_full_batch_gaussian_moments():
    s = mt.SGHMC(_std_normal_grad(), _init(32, 2), step_size=0.02,
                 friction=0.1, seed=21, **CPU)
    flat = _np(s.run(6000, 1000)).reshape(-1, 2)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.1), flat.mean(axis=0)
    assert np.all(np.abs(flat.var(axis=0) - 1.0) < 0.15), flat.var(axis=0)


def test_sghmc_minibatch_conjugate_posterior():
    log_prior, log_like, data, post_mean, post_var = _conjugate_problem()
    grad_fn = mt.minibatch_grad(log_prior, log_like, data, batch_size=64,
                                **CPU)
    init = torch.tensor(post_mean, dtype=torch.float32)[None].repeat(8, 1)
    s = mt.SGHMC(grad_fn, init, step_size=2e-4, friction=0.3, seed=13,
                 **CPU)
    flat = _np(s.run(3000, 1000)).reshape(-1, 2)
    assert np.all(np.abs(flat.mean(axis=0) - post_mean)
                  < 3 * np.sqrt(post_var)), (flat.mean(axis=0), post_mean)


def test_sghmc_validation():
    g = _std_normal_grad()
    for friction in (0.0, 1.5):
        with pytest.raises(ValueError, match="friction"):
            mt.SGHMC(g, _init(2, 2), step_size=0.01, friction=friction,
                     **CPU)


# -- shared contracts (tests/test_sgmcmc.py:297-353) --------------------------


def test_sgld_run_continuation():
    s = mt.SGLD(_std_normal_grad(), _init(4, 2), step_size=0.05, seed=17,
                **CPU)
    s.run(10, 0)
    first_end = _np(s.positions).copy()
    sample2 = s.run(10, 0)
    assert s.state.step == 20
    assert not np.allclose(_np(sample2[:, -1]), first_end)


def test_sgld_run_progress_reports_full_acceptance():
    s = mt.SGLD(_std_normal_grad(), _init(4, 2), step_size=0.05, seed=7,
                **CPU)
    out = io.StringIO()
    sample, stats = s.run_progress(64, 16, stream=out)
    assert sample.shape == (4, 64, 2)
    assert np.isfinite(stats.ess.mean) and stats.ess.mean > 0
    rates = [float(v) for v in
             re.findall(r"p\(accept\)≈(\d+\.\d+)", out.getvalue())]
    assert len(rates) >= 5 and min(rates[-5:]) > 0.9, rates


def test_state_and_settings_carry_across():
    data, prior, like, jprior, jlike = _regression()
    x = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    with jax.enable_x64(False):
        jg = jsg.minibatch_grad(jprior, jlike, tuple(map(jnp.asarray, data)),
                                32)
        j1 = JaxSGLD(jg, jnp.asarray(x), jsg.polynomial_decay(1e-4, 50.0,
                                                              0.33),
                     seed=1, temperature=0.5, preconditioner="rmsprop",
                     rms_decay=0.999, rms_eps=1e-6, steps_per_call=4)
        j1.run(8, 0)
        j2 = JaxSGHMC(jg, jnp.asarray(x), 1e-4, seed=1, friction=0.2,
                      temperature=0.9)
        j2.run(3, 0)
        s1 = [np.array(v) for v in j1.state]
        s2 = [np.array(v) for v in j2.state]
    grad = mt.minibatch_grad(prior, like, data_from_numpy(data, **CPU), 32,
                             **CPU)
    kw1 = sgld_sampler_kwargs(j1, schedule=(1e-4, 50.0, 0.33))
    assert kw1 == dict(step_size=mt.polynomial_decay(1e-4, 50.0, 0.33),
                       temperature=0.5, preconditioner="rmsprop",
                       rms_decay=0.999, rms_eps=1e-6, steps_per_call=4)
    with pytest.raises(ValueError, match="schedule"):
        sgld_sampler_kwargs(j1)
    kw2 = sghmc_sampler_kwargs(j2)
    assert kw2 == dict(step_size=1e-4, friction=0.2, temperature=0.9,
                       steps_per_call=1)
    p1 = mt.SGLD(grad, torch.from_numpy(x), **kw1, **CPU)
    p1.state = sgld_state_from_numpy(*s1, **CPU)
    assert p1.state.step == 8 and p1.run(4).shape == (8, 4, 4)
    p2 = mt.SGHMC(grad, torch.from_numpy(x), **kw2, **CPU)
    p2.state = sghmc_state_from_numpy(*s2, **CPU)
    np.testing.assert_array_equal(_np(p2.state.momenta), s2[1])
    assert p2.run(2).shape == (8, 2, 4) and p2.state.step == 5
    # the unused pSGLD average crosses as a 0-d zero
    st = sgld_state_from_numpy(x, np.float32(0.0), 0, **CPU)
    assert st.sq_avg.shape == () and mt.SGLD(
        grad, torch.from_numpy(x), 1e-4, **CPU).state.sq_avg.shape == ()
