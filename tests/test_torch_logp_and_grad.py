"""``Target.logp_and_grad``, the single-``[D]``-state form
(``mini_mcmc_tpu/models/base.py:91-95``), against the JAX one on the same
numpy states: a target with an analytic ``grad`` (the logistic regression
of ``examples/logistic_regression_nuts.py`` and the Rosenbrock
``rosenbrock_nd``), targets with ``logp`` alone (autograd against
``jax.value_and_grad``: the 2D Rosenbrock density of
``examples/rosenbrock_mh.py`` and the centered eight schools) and eight
schools' non-centered form (the port's hand gradient against JAX's AD).
Tolerance 1e-5 (relative, and absolute on values of order one).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import eight_schools as es
from mini_mcmc_torch.examples import logistic_regression_nuts as lr
from mini_mcmc_torch.examples import rosenbrock_mh as rmh
from mini_mcmc_torch.models import Target
from mini_mcmc_tpu import models as jm

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples.{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logistic_data():
    g = np.random.default_rng(5)
    X = g.standard_normal((64, 4)).astype(np.float32)
    y = (g.uniform(size=64) < 0.5).astype(np.float32)
    return X, y


def _pair(case):
    """(port target, JAX target, dim, state scale) of a case."""
    if case == "logistic_grad":
        X, y = _logistic_data()
        jx = _jax_example("logistic_regression_nuts")
        return lr.make_logistic_target(X, y), jx.make_logistic_target(
            X, y), 4, 1.0
    if case == "rosenbrock_nd_grad":
        return mt.rosenbrock_nd(), jm.rosenbrock_nd(), 3, 0.6
    if case == "rosenbrock2d_logp":
        return Target(logp=rmh.rosenbrock_logp), jm.Target(
            logp=lambda p: -((1.0 - p[0]) ** 2
                             + 100.0 * (p[1] - p[0] * p[0]) ** 2) / 20.0
        ), 2, 0.6
    jx = _jax_example("eight_schools_nuts")
    if case == "eight_schools_centered":
        return es.make_centered_target(), jx.make_centered_target(), 10, 0.5
    return (es.make_noncentered_target(), jx.make_noncentered_target(), 10,
            0.5)


CASES = ["logistic_grad", "rosenbrock_nd_grad", "rosenbrock2d_logp",
         "eight_schools_centered", "eight_schools_noncentered"]


@pytest.mark.parametrize("case", CASES)
def test_logp_and_grad_matches_jax(case):
    t, jt, dim, scale = _pair(case)
    assert (t.grad is not None) == case.endswith(("grad", "noncentered"))
    g = np.random.default_rng(len(case))
    for _ in range(4):
        x = (scale * g.standard_normal(dim)).astype(np.float32)
        lp, gr = t.logp_and_grad(torch.from_numpy(x))
        want_lp, want_gr = jt.logp_and_grad(jnp.asarray(x))
        assert lp.shape == () and gr.shape == (dim,)
        assert not lp.requires_grad and not gr.requires_grad
        np.testing.assert_allclose(float(lp), float(want_lp), **TOL)
        np.testing.assert_allclose(gr.numpy(), np.asarray(want_gr), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_logp_and_grad_is_a_row_of_the_batch_form(case):
    """One state's value and gradient equal the batch form's row for it,
    on the state's own device, whatever the target carries."""
    t, _, dim, scale = _pair(case)
    x = torch.from_numpy((scale * np.random.default_rng(3).standard_normal(
        (6, dim))).astype(np.float32))
    vals, grads = t.batch_logp_and_grad(x)
    for i in range(x.shape[0]):
        lp, gr = t.logp_and_grad(x[i])
        assert lp.device == x.device and gr.device == x.device
        np.testing.assert_allclose(float(lp), float(vals[i]), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(gr.numpy(), grads[i].numpy(), rtol=1e-6,
                                   atol=1e-5)


def test_logp_and_grad_leaves_the_input_alone():
    """The autograd path differentiates a detached copy: a state that
    carries a graph comes back unchanged, and the outputs hold none."""
    t = Target(logp=rmh.rosenbrock_logp)
    x = torch.tensor([0.3, -0.2], requires_grad=True)
    y = x * 2.0
    lp, gr = t.logp_and_grad(y)
    assert y.grad_fn is not None and x.grad is None
    want = jax.grad(lambda p: -((1.0 - p[0]) ** 2 + 100.0 * (
        p[1] - p[0] * p[0]) ** 2) / 20.0)(jnp.asarray([0.6, -0.4]))
    np.testing.assert_allclose(gr.numpy(), np.asarray(want), **TOL)
    assert lp.grad_fn is None and gr.grad_fn is None
