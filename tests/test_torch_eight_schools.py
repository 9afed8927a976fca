"""The eight-schools posterior (``mini_mcmc_torch/examples/eight_schools.py``)
against ``examples/eight_schools_nuts.py`` on the same numpy inputs, and
sampled in natural ``tau > 0`` coordinates through ``transform=``.

Tolerances: the non-centered density and its hand-written gradient at rtol
1e-5 in float32 (JAX pinned to float32); the quadrature means at 1e-12
(the same numpy); the natural-tau NUTS run to the JAX test's 0.3 (mu) and
0.5 (tau) of the exact means (``tests/test_transforms.py:135-163``); the
ChEES stage (``bench.py:1342-1372``) at 256 chains to the bench's own
gates.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import eight_schools as es
from mini_mcmc_torch.models import CoordinateTransform, positive

torch.set_num_threads(1)


def _load_es8():
    spec = importlib.util.spec_from_file_location(
        "es8_torch", os.path.join(os.path.dirname(__file__), "..",
                                  "examples", "eight_schools_nuts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(n, seed):
    g = np.random.default_rng(seed)
    p = g.standard_normal((n, 10)).astype(np.float32)
    p[:, 0] = 5.0 * p[:, 0]  # mu on its prior's scale
    return p


def test_noncentered_target_matches_the_jax_example():
    es8 = _load_es8()
    np.testing.assert_array_equal(es.Y, es8.Y)
    np.testing.assert_array_equal(es.SIGMA, es8.SIGMA)
    jt = es8.make_noncentered_target()
    t = es.make_noncentered_target()
    p = _params(256, 0)
    with jax.enable_x64(False):
        jp = jnp.asarray(p)
        want_lp = np.asarray(jt.logp_batch(jp))
        want_g = np.asarray(jt.grad_dc(jp.T)).T
        want_one = float(jt.logp(jp[3]))
    pt = torch.from_numpy(p)
    np.testing.assert_allclose(t.batch_logp(pt).numpy(), want_lp, rtol=1e-5,
                               atol=1e-5)
    got_g = t.batch_grad(pt).numpy()
    scale = np.abs(want_g).max(axis=1, keepdims=True)
    assert (np.abs(got_g - want_g) <= 1e-5 * (np.abs(want_g) + scale)).all()
    assert abs(float(t.logp(pt[3])) - want_one) <= 1e-5 * abs(want_one)
    # the hand-written gradient is autograd's of the batch form
    x = pt.double().requires_grad_(True)
    (ad,) = torch.autograd.grad(t.batch_logp(x).sum(), x)
    torch.testing.assert_close(t.batch_grad(pt.double()), ad)


def test_exact_posterior_means_equal_the_example():
    es8 = _load_es8()
    np.testing.assert_allclose(es.exact_posterior_means(),
                               es8.exact_posterior_means(), rtol=1e-12,
                               atol=1e-12)


def test_natural_target_wrapped_is_the_noncentered_density():
    # tau = exp(log_tau) with its Jacobian: the wrap of the natural target
    # under positive() is the hand-rolled non-centered density
    tf = CoordinateTransform({1: positive()}, dim=10)
    wrapped = tf.wrap(es.make_natural_target())
    p = torch.from_numpy(_params(128, 1))
    torch.testing.assert_close(wrapped.batch_logp(p),
                               es.make_noncentered_target().batch_logp(p),
                               rtol=1e-5, atol=1e-5)


def test_natural_tau_nuts_recovers_the_exact_means():
    # tests/test_transforms.py:135-163 at 64 chains on the lockstep tier
    tf = CoordinateTransform({1: positive()}, dim=10)
    x0 = tf.to_x(mt.init_with_seed(64, 10, seed=3, device="cpu"))
    s = mt.NUTS(es.make_natural_target(), x0, 0.8, max_depth=6,
                transform=tf, device="cpu").seed(3)
    s.run(0, 200)
    x = s.run(200, 50).reshape(-1, 10).numpy()
    exact_mu, exact_tau = es.exact_posterior_means()
    assert abs(float(x[:, 0].mean()) - exact_mu) < 0.3
    assert abs(float(x[:, 1].mean()) - exact_tau) < 0.5
    assert (x[:, 1] > 0).all()  # tau stays in its natural range


def test_chees_stage_passes_the_bench_gates_at_a_small_size():
    # bench.py:1342-1372 at 256 chains, warmed_up(150), run(256, 64): the
    # bench's moment gates; a shifted cube fails its E[mu] gate by name
    ch = es.chees_adapted(device="cpu", n_chains=256, n_adapt=150)
    assert ch.traj_len > 2.0 * ch.step_size
    sample = ch.run(256, 64)
    m = es.moment_gates("8schools chees", sample)
    assert m["ess_min"] >= 0.002 * 256 * 256
    shifted = sample.clone()
    shifted[..., 0] += 1.0
    with pytest.raises(AssertionError, match="8schools chees E\\[mu\\]"):
        es.moment_gates("8schools chees", shifted)
