"""mini_mcmc_torch.models and utils.init against the JAX package.

The same numpy inputs go through both packages' Rosenbrock targets, with
the analytic gradients and with autograd. Tolerance: rtol 1e-5 in float32
(both evaluate the same formula in the same operation order; the JAX side
is pinned to float32 since the suite enables x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import Target, rosenbrock2d, rosenbrock_nd
from mini_mcmc_tpu import models as jm

torch.set_num_threads(1)

RTOL = 1e-5


def _positions(c, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, d)) * 0.7 + 0.8).astype(np.float32)


def _jax_ref(target, x):
    lp, g = target.batch_logp_and_grad(jnp.asarray(x, jnp.float32))
    return np.asarray(lp, np.float32), np.asarray(g, np.float32)


def _close(got, want):
    # atol scaled to the values: the gradient's x_{i+1} - x_i^2 cancellation
    # leaves absolute float32 noise near its zeros
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("d", [2, 3, 5])
def test_rosenbrock_nd_matches_jax(d):
    x = _positions(64, d, seed=d)
    want_lp, want_g = _jax_ref(jm.rosenbrock_nd(), x)
    lp, g = rosenbrock_nd().batch_logp_and_grad(torch.from_numpy(x))
    _close(lp, want_lp)
    _close(g, want_g)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_rosenbrock_nd_autograd_matches_jax(d):
    x = _positions(64, d, seed=10 + d)
    want_lp, want_g = _jax_ref(jm.rosenbrock_nd(), x)
    no_grad = Target(logp=rosenbrock_nd().logp)
    lp, g = no_grad.batch_logp_and_grad(torch.from_numpy(x))
    _close(lp, want_lp)
    _close(g, want_g)
    _close(no_grad.batch_grad(torch.from_numpy(x)), want_g)


@pytest.mark.parametrize("a,b", [(1.0, 100.0), (0.5, 20.0)])
def test_rosenbrock2d_matches_jax(a, b):
    x = _positions(64, 2, seed=3)
    want_lp, want_g = _jax_ref(jm.rosenbrock2d(a, b), x)
    port = rosenbrock2d(a, b)
    lp, g = port.batch_logp_and_grad(torch.from_numpy(x))
    _close(lp, want_lp)
    _close(g, want_g)
    _, g_ad = Target(logp=port.logp).batch_logp_and_grad(torch.from_numpy(x))
    _close(g_ad, want_g)


def test_single_state_logp_matches_batch():
    x = torch.from_numpy(_positions(4, 3))
    t = rosenbrock_nd()
    for i in range(4):
        assert torch.equal(t.logp(x[i]), t.batch_logp(x)[i])
        assert torch.equal(t.grad(x[i]), t.batch_grad(x)[i])


def test_logp_batch_override_is_used():
    t = Target(logp=lambda p: -0.5 * (p * p).sum(-1),
               logp_batch=lambda p: -(p * p).sum(-1))
    x = torch.full((3, 2), 2.0)
    lp, g = t.batch_logp_and_grad(x)
    assert torch.equal(lp, torch.full((3,), -8.0))
    assert torch.equal(g, -2.0 * x)  # autograd of the override


def test_cuda_functor_names():
    assert rosenbrock_nd().cuda_functor == "rosenbrock_nd"
    assert rosenbrock2d().cuda_functor is None


def test_init_helpers():
    cpu = dict(device="cpu")
    a = mt.init_with_seed(16, 3, seed=5, **cpu)
    assert a.shape == (16, 3) and a.dtype == torch.float32
    assert torch.equal(a, mt.init_with_seed(16, 3, seed=5, **cpu))
    assert not torch.equal(a, mt.init_with_seed(16, 3, seed=6, **cpu))
    assert torch.equal(mt.init_det(8, 2, **cpu),
                       mt.init_with_seed(8, 2, seed=42, **cpu))
    assert mt.init_det(4, 2, dtype=torch.float64,
                       **cpu).dtype == torch.float64
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(mt.init(16, 3, gen, **cpu), a)
    assert mt.init(3, 2, **cpu).shape == (3, 2)
    # standard normal: moments over a larger draw
    big = mt.init_with_seed(4096, 4, seed=1, **cpu).double()
    assert abs(float(big.mean())) < 4 / np.sqrt(big.numel())
    assert abs(float(big.var()) - 1.0) < 0.05


def test_jax_side_is_float32():
    # guards the pinning above: the suite runs JAX with x64 enabled
    lp, _ = jm.rosenbrock_nd().batch_logp_and_grad(
        jnp.asarray(_positions(2, 3), jnp.float32))
    assert lp.dtype == jnp.float32
    assert jax.config.jax_enable_x64
