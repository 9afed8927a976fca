"""The port's examples (``mini_mcmc_torch/examples/``) against the JAX
package's (``examples/``): each target builder the JAX example defines,
fed the same seeded numpy data and states as the JAX one (the JAX module
loaded by ``importlib`` as ``tests/test_examples.py`` loads it), and the
eight-schools example's ``main`` as the composition of its two halves,
and its centered half at the JAX defaults: with ``--dist loadfile``
xdist hands out the files with the most tests first, so this file's
minutes start with the run. The other examples' ``main`` run in
``test_torch_examples_nuts.py`` and ``test_torch_examples_run.py``, eight
schools' non-centered half in ``test_torch_examples_eight_schools.py``.

Tolerances, those of ``tests/test_examples.py:69-74``: values at rtol
2e-6 / atol 2e-5, gradients at rtol 2e-5 / atol 2e-5 (float32 on both
sides, the sums in other orders).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch.examples import ais_log_z as ais
from mini_mcmc_torch.examples import bimodal_tempering as bt
from mini_mcmc_torch.examples import constrained_transforms as ct
from mini_mcmc_torch.examples import eight_schools as es
from mini_mcmc_torch.examples import gp_robust_regression as gp
from mini_mcmc_torch.examples import logistic_regression_nuts as lr
from mini_mcmc_torch.examples import rosenbrock_mh as rmh

VALUE_TOL = dict(rtol=2e-6, atol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(4)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples.{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rosenbrock_logp(pos):
    """examples/rosenbrock_mh.py:16-18, the density its main defines."""
    x, y = pos[0], pos[1]
    return -((1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2) / 20.0


def _jax_ais_batch_logp(theta, y):
    """examples/ais_log_z.py:30-37, the posterior its main defines, of
    its data ``y``."""
    t = theta[:, 0]
    log_prior = -0.5 * (t**2 + jnp.log(2 * jnp.pi))
    log_lik = jnp.sum(
        -0.5 * ((y[None, :] - t[:, None]) ** 2 + jnp.log(2 * jnp.pi)),
        axis=1)
    return log_prior + log_lik


def _logistic_data(seed):
    g = np.random.default_rng(100 + seed)
    X = g.standard_normal((256, 4)).astype(np.float32)
    y = (g.uniform(size=256) < 0.5).astype(np.float32)
    return X, y


def _batch_pair(case, seed):
    """(port ``[C, D] -> [C]``, JAX ``[C, D] -> [C]``, states ``[C, D]``)
    of a builder's batch density."""
    g = np.random.default_rng(seed)

    def states(c, d, scale=1.0, shift=0.0):
        return (shift + scale * g.standard_normal((c, d))).astype(np.float32)

    if case == "logistic_logp_batch":
        X, y = _logistic_data(seed)
        jt = _jax_example("logistic_regression_nuts").make_logistic_target(
            X, y)
        return (lr.make_logistic_target(X, y).logp_batch, jt.logp_batch,
                states(16, 4, 0.7))
    if case == "logistic_logp":
        X, y = _logistic_data(seed)
        jt = _jax_example("logistic_regression_nuts").make_logistic_target(
            X, y)
        return (lr.make_logistic_target(X, y).logp, jax.vmap(jt.logp),
                states(16, 4, 0.7))
    if case == "rosenbrock_logp":
        return (rmh.rosenbrock_logp, jax.vmap(_jax_rosenbrock_logp),
                states(32, 2, 0.8, 0.5))
    if case in ("bimodal_logp", "bimodal_logp_batch"):
        jt = _jax_example("bimodal_tempering").bimodal()
        pt = bt.bimodal()
        x = states(32, 1, 8.0)
        if case == "bimodal_logp":
            return pt.logp, jax.vmap(jt.logp), x
        return pt.logp_batch, jt.logp_batch, x
    if case == "ais_batch_logp":
        yt = torch.from_numpy(ais.Y)
        return (lambda t: ais.batch_logp(t, yt),
                lambda t: _jax_ais_batch_logp(t, jnp.asarray(ais.Y)),
                states(32, 1, 1.5))
    if case == "gp_student_t_loglik":
        jx = _jax_example("gp_robust_regression")
        y = states(1, gp.N_POINTS)[0]
        return (lambda f: gp.student_t_loglik(torch.from_numpy(y) - f,
                                              gp.NU, gp.NOISE_STD),
                jax.vmap(lambda f: jx.student_t_loglik(
                    jnp.asarray(y) - f, jx.NU, jx.NOISE_STD)),
                states(8, gp.N_POINTS, 0.5))
    if case == "natural_logp_batch":
        jt = _jax_example("constrained_transforms").make_natural_target()
        lam = np.exp(states(32, 1, 0.5, 1.0))
        p = 1.0 / (1.0 + np.exp(-states(32, 1, 1.0)))
        x = np.concatenate([lam, p], 1).astype(np.float32)
        return ct.make_natural_target().logp_batch, jt.logp_batch, x
    jx = _jax_example("eight_schools_nuts")
    x = states(16, 10, 0.8)
    x[:, 1] = np.clip(x[:, 1], -2.0, 2.0)  # log tau
    if case == "eight_schools_centered":
        return (es.make_centered_target().logp_batch,
                jx.make_centered_target().logp_batch, x)
    return (es.make_noncentered_target().logp_batch,
            jx.make_noncentered_target().logp_batch, x)


BATCH_CASES = ["logistic_logp_batch", "logistic_logp", "rosenbrock_logp",
               "bimodal_logp", "bimodal_logp_batch", "ais_batch_logp",
               "gp_student_t_loglik", "natural_logp_batch",
               "eight_schools_centered", "eight_schools_noncentered"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", BATCH_CASES)
def test_builders_match_the_jax_example(case, seed):
    """Values, and gradients by autograd against jax.grad, per row."""
    port, jax_fn, x = _batch_pair(case, seed)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    (g,) = torch.autograd.grad(got.sum(), xt)
    want = np.asarray(jax_fn(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax_fn(v)))(
        jnp.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUE_TOL)
    np.testing.assert_allclose(g.numpy(), want_g, **GRAD_TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_logistic_analytic_grad_matches_the_jax_example(seed):
    X, y = _logistic_data(seed)
    jt = _jax_example("logistic_regression_nuts").make_logistic_target(X, y)
    beta = (0.7 * np.random.default_rng(seed).standard_normal((16, 4))
            ).astype(np.float32)
    got = lr.make_logistic_target(X, y).grad(torch.from_numpy(beta))
    want = np.asarray(jax.vmap(jt.grad)(jnp.asarray(beta)))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_gp_rbf_kernel_and_exact_values_match_the_jax_examples():
    jx = _jax_example("gp_robust_regression")
    x = np.linspace(-3.0, 3.0, gp.N_POINTS).astype(np.float32)
    np.testing.assert_allclose(
        gp.rbf_kernel(torch.from_numpy(x)).numpy(),
        np.asarray(jx.rbf_kernel(jnp.asarray(x))), **VALUE_TOL)
    assert ct.exact_moments() == _jax_example(
        "constrained_transforms").exact_moments()
    n = ais.Y.shape[0]
    cov = np.eye(n) + np.ones((n, n))
    want = -0.5 * (n * math.log(2 * math.pi) + np.linalg.slogdet(cov)[1]
                   + float(ais.Y @ np.linalg.solve(cov, ais.Y)))
    assert math.isclose(ais.exact_log_z(), want, rel_tol=1e-12)


def test_eight_schools_main_composes_its_halves(monkeypatch, capsys):
    """``main`` prints the quadrature's means, then runs the non-centered
    half and the centered one with the JAX example's defaults (32 chains,
    ``run(1000, 500)`` twice each) and returns the non-centered half's
    ``(E[mu], E[tau])``. The halves themselves run at those defaults in
    ``test_torch_examples_eight_schools.py`` and below."""
    calls = []
    monkeypatch.setattr(es, "noncentered_half", lambda *a: calls.append(
        ("noncentered", a)) or (4.4, 3.6))
    monkeypatch.setattr(es, "centered_half", lambda *a: calls.append(
        ("centered", a)) or 0.03)
    assert es.main(device="cpu") == (4.4, 3.6)
    assert calls == [("noncentered", (32, 1000, 500, "cpu")),
                     ("centered", (1000, 500, "cpu"))]
    exact_mu, exact_tau = es.exact_posterior_means()
    assert capsys.readouterr().out == (
        f"exact:        E[mu]={exact_mu:.3f}  E[tau]={exact_tau:.3f}\n")


def test_eight_schools_centered_half_at_the_jax_defaults(capsys):
    """The centered half at the JAX example's defaults
    (``examples/eight_schools_nuts.py:187-193``: 16 chains, seed 5,
    ``run(1000, 500)`` twice on the lockstep tier, the funnel's deep trees
    at ~175 leapfrogs a draw) returns its steady-state divergence rate, a
    share of the steps, and prints it: the JAX example asserts nothing of
    it."""
    rate = es.centered_half(device="cpu")
    assert math.isfinite(rate) and 0.0 <= rate <= 1.0
    assert f"steady-state divergence rate={rate:.2%}" in (
        capsys.readouterr().out)
