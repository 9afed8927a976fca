"""Gibbs sampling in the port against the JAX package.

- One sweep on identical draws: the JAX package's chains-on-lanes
  conditional (``sample_dc`` of ``mini_mcmc_tpu/models/mixture.py:50-65``)
  fed a namespace of fixed draws in place of the TPU stream, against
  Kernel 6's plain twin fed the word stream those draws come from: x
  within one float32 ulp, z equal on every chain whose uniform lies more
  than 1e-6 from p(z=1) (one ulp of p can flip ``u < p``).
- The word stream's layout: one sweep of the twin at the last chain index
  and a step past 2**31 equals one hand-computed from ``rng.philox_words``.
- The twin's draws depend only on (key, chain, global step).
- The samplers on the CPU, both tiers, beside ``mini_mcmc_tpu``'s
  ``use_pallas=False`` sampler from the same numpy start, under the gates
  of ``tests/test_gibbs.py:18-48`` at a reduced size (1,024 chains x 400
  sweeps after 100, cut from 8 chains x 25,000 after 2,500).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import gibbs_sampler_kwargs
from mini_mcmc_torch.models import (
    Conditional,
    constant_conditional,
    gaussian_mixture_conditional,
)
from mini_mcmc_torch.models.mixture import mixture_coordinate
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.gibbs_full import (
    SAMPLE_FROM_WORDS,
    gibbs_instance,
    gibbs_multistep,
    gibbs_multistep_plain,
)
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm

torch.set_num_threads(1)

MIX = (-2.0, 1.0, 3.0, 1.5, 0.5)  # reference parameter set 1, gibbs.rs:390
TRUE_MEAN = 0.5 * -2.0 + 0.5 * 3.0
TRUE_VAR = 0.5 * (1.0 + (-2.0 - TRUE_MEAN) ** 2) + 0.5 * (
    1.5**2 + (3.0 - TRUE_MEAN) ** 2)
CPU = dict(device="cpu")
ULP = 2.0**-23


class _FixedDraws:
    """The JAX package's in-kernel rng namespace with fixed arrays."""

    def __init__(self, normals=None, uniform=None):
        self._normals, self._uniform = normals, uniform

    def normals(self, shape):
        assert self._normals.shape == tuple(shape)
        return jnp.asarray(self._normals)

    def uniform(self, shape):
        assert self._uniform.shape == tuple(shape)
        return jnp.asarray(self._uniform)


def _p_z1(x):
    """p(z = 1 | x) in float64, for the tie mask."""
    mu0, s0, mu1, s1, pi0 = MIX

    def pdf(mu, s):
        return np.exp(-((x - mu) ** 2) / (2 * s * s)) / np.sqrt(
            2 * np.pi * s * s)

    p0, p1 = pi0 * pdf(mu0, s0), (1 - pi0) * pdf(mu1, s1)
    total = p0 + p1
    return np.where(total > 0, p1 / np.where(total > 0, total, 1.0), 0.5)


def _assert_z(z, want_z, u, x):
    away = np.abs(u - _p_z1(np.asarray(x, np.float64))) > 1e-6
    assert away.mean() > 0.99
    np.testing.assert_array_equal(np.asarray(z)[away],
                                  np.asarray(want_z)[away])


def test_one_sweep_equals_jax_on_identical_draws():
    c = 4096
    g = np.random.default_rng(0)
    state = np.stack([g.normal(0.5, 3.0, c),
                      g.integers(0, 2, c)], axis=1).astype(np.float32)
    w = rng.stream_words(c, 3, 9, 0xBEEF)
    normal = rng.box_muller(w[:, 0], w[:, 1]).numpy()
    u = rng.unit_open(w[:, 2]).numpy()
    fixed = _FixedDraws(normals=normal, uniform=u)
    jc = jm.gaussian_mixture_conditional(*MIX)
    s = jnp.asarray(state.T)
    x = jc.sample_dc(fixed, 0, s)
    s = jnp.concatenate([x[None], s[1][None]], axis=0)
    z = jc.sample_dc(fixed, 1, s)
    cond = gaussian_mixture_conditional(*MIX)
    got = gibbs_multistep_plain(cond, torch.from_numpy(state), 0, 0, 1,
                                words=w[None])
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(x), rtol=ULP,
                               atol=0)
    _assert_z(got[:, 1].numpy(), z, u, got[:, 0].numpy())
    assert 0.2 < float(got[:, 1].mean()) < 0.8


def test_one_sweep_follows_the_word_stream_layout():
    """One sweep of the twin at the last chains and a step past 2**31
    equals one hand-computed from rng.philox_words: x's normal from
    box_muller on words 0 and 1, z's uniform from word 2, one Philox
    evaluation (the counter (chain, step, 0, 0)) a sweep."""
    seed, chain0, step = 0x1234_5678_9ABC_DEF0, 2**32 - 4, 2**31 + 11
    words_of, _ = SAMPLE_FROM_WORDS["gaussian_mixture"]
    assert words_of(2) == 3
    words = torch.tensor([rng.philox_words(ch, step, 0, 0, seed)
                          for ch in range(chain0, chain0 + 4)])
    state = torch.tensor([[-2.5, 0.0], [0.4, 1.0], [3.1, 0.0], [9.0, 1.0]])
    cond = gaussian_mixture_conditional(*MIX)
    want = state.clone()
    want[:, 0] = mixture_coordinate(
        cond.cuda_params, 0, want, rng.box_muller(words[:, 0], words[:, 1]),
        None)
    want[:, 1] = mixture_coordinate(cond.cuda_params, 1, want, None,
                                    rng.unit_open(words[:, 2]))
    got = gibbs_multistep_plain(cond, state, seed, step, 1, chain0=chain0)
    assert torch.equal(got, want)


def test_z_conditional_equals_jax_including_underflow():
    """p(z = 1 | x) on given x, including |x| so far out that both
    densities underflow to 0 and the guard selects 0.5."""
    c = 4096
    g = np.random.default_rng(1)
    x = g.normal(0.5, 4.0, c).astype(np.float32)
    x[:8] = [60.0, -60.0, 200.0, -200.0, 12.0, -9.0, 0.5, 3.0]
    state = np.stack([x, np.zeros(c, np.float32)], axis=1)
    u = g.uniform(1e-6, 1.0, c).astype(np.float32)
    cond = gaussian_mixture_conditional(*MIX)
    got = mixture_coordinate(cond.cuda_params, 1, torch.from_numpy(state),
                             None, torch.from_numpy(u))
    want = jm.gaussian_mixture_conditional(*MIX).sample_dc(
        _FixedDraws(uniform=u), 1, jnp.asarray(state.T))
    _assert_z(got.numpy(), want, u, x)
    # far out both densities are 0: the guard's 0.5
    far = mixture_coordinate(cond.cuda_params, 1,
                             torch.tensor([[200.0, 0.0]] * 2), None,
                             torch.tensor([0.4999, 0.5001]))
    assert far.tolist() == [1.0, 0.0]


def test_twin_cube_does_not_depend_on_blocks_or_chain_split():
    cond = gaussian_mixture_conditional(*MIX)
    x = torch.zeros((64, 2))
    seed, k = 0x5EED, 16
    one = torch.empty((k, 64, 2))
    a = gibbs_multistep(cond, x, seed, 7, k, one)
    steps = torch.empty_like(one)
    s = x
    for i in range(k):
        s = gibbs_multistep(cond, s, seed, 7 + i, 1, steps[i:i + 1])
    halves = torch.empty_like(one)
    h = [gibbs_multistep(cond, x[sl], seed, 7, k, halves[:, sl],
                         chain0=sl.start)
         for sl in (slice(0, 32), slice(32, 64))]
    assert torch.equal(one, steps) and torch.equal(one, halves)
    assert torch.equal(a, s) and torch.equal(a, torch.cat(h))
    assert torch.equal(one[-1], a)
    other = torch.empty_like(one)
    gibbs_multistep(cond, x, seed + 1, 7, k, other)
    assert not torch.equal(one, other)


def _gates(sample):
    xs = np.asarray(sample[..., 0], np.float64).ravel()
    zs = np.asarray(sample[..., 1], np.float64).ravel()
    assert abs(xs.mean() - TRUE_MEAN) < abs(TRUE_MEAN) / 10.0, xs.mean()
    assert abs(xs.var() - TRUE_VAR) < TRUE_VAR / 10.0, xs.var()
    assert abs(zs.mean() - 0.5) < 0.05, zs.mean()


@pytest.mark.parametrize("use_pallas,k", [(False, 1), (False, 50),
                                          ("full", 1), ("full", 50)])
def test_mixture_moments_beside_jax(use_pallas, k):
    init = np.zeros((1024, 2), np.float32)
    port = mt.GibbsSampler(gaussian_mixture_conditional(*MIX), init,
                           use_pallas=use_pallas, steps_per_call=k,
                           **CPU).seed(42)
    sample = port.run(400, 100)
    assert sample.shape == (1024, 400, 2) and sample.dtype == torch.float32
    assert set(sample[..., 1].unique().tolist()) <= {0.0, 1.0}
    _gates(sample.numpy())
    j = jmt.GibbsSampler(jm.gaussian_mixture_conditional(*MIX),
                         jnp.asarray(init)).seed(42)
    _gates(np.asarray(j.run(400, 100)))


def test_constant_conditional_converges_in_one_sweep():
    s = mt.GibbsSampler(constant_conditional(7.0), torch.zeros((3, 3)),
                        **CPU).seed(0)
    assert torch.equal(s.run(1, 0), torch.full((3, 1, 3), 7.0))


def test_sweep_conditions_on_fresh_values():
    # coordinate 1 copies coordinate 0 after its increment (gibbs.rs:95-99)
    def sample(gen, index, states):
        return states[..., 0] + 1.0 if index == 0 else states[..., 0]

    s = mt.GibbsSampler(Conditional(sample=sample), torch.zeros((2, 2)),
                        **CPU).seed(0)
    assert torch.equal(s.run(1, 0), torch.ones((2, 1, 2)))


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_runs_continue_and_seeds_reproduce(use_pallas):
    init = torch.zeros((16, 2))

    def make(seed=1, k=4):
        return mt.GibbsSampler(gaussian_mixture_conditional(*MIX), init,
                               use_pallas=use_pallas, steps_per_call=k,
                               **CPU).seed(seed)

    s = make()
    first = s.run(8, 0)
    assert torch.equal(s.positions, first[:, -1])
    assert not torch.equal(s.run(8, 0)[:, 0], first[:, 0])
    cm = make().run(8, 4)
    assert torch.equal(make().run(8, 4, time_major=True).transpose(0, 1),
                       cm)
    assert not torch.equal(make(2).run(8, 4), cm)
    if use_pallas:
        assert torch.equal(make(k=1).run(8, 4), cm)
    assert torch.equal(init, torch.zeros((16, 2)))  # copied, not aliased


def test_constructor_validation():
    cond = gaussian_mixture_conditional(*MIX)
    with pytest.raises(ValueError, match='use_pallas="full"'):
        mt.GibbsSampler(cond, torch.zeros((8, 2)), use_pallas=True, **CPU)
    with pytest.raises(ValueError, match="sample_words"):
        mt.GibbsSampler(constant_conditional(1.0), torch.zeros((8, 2)),
                        use_pallas="full", **CPU)
    with pytest.raises(ValueError, match="steps_per_call"):
        mt.GibbsSampler(cond, torch.zeros((8, 2)), steps_per_call=0, **CPU)
    with pytest.raises(ValueError, match=r"\(gaussian_mixture, D=2\)"):
        gibbs_instance(cond, 3)
    assert gibbs_instance(cond, 2) == 0


def test_gibbs_sampler_kwargs_read_the_jax_step_function():
    cond = jm.gaussian_mixture_conditional(*MIX)
    init = jnp.zeros((1024, 2), jnp.float32)
    cases = [(dict(), dict(use_pallas=False, steps_per_call=1)),
             (dict(steps_per_call=8), dict(use_pallas=False,
                                           steps_per_call=8)),
             (dict(use_pallas="full", steps_per_call=32),
              dict(use_pallas="full", steps_per_call=32))]
    for jkw, want in cases:
        j = jmt.GibbsSampler(cond, init, **jkw)
        # use_pallas is the caller's: the JAX sampler does not expose it
        assert gibbs_sampler_kwargs(
            j, use_pallas=jkw.get("use_pallas", False)) == want
    port = mt.GibbsSampler(gaussian_mixture_conditional(*MIX),
                           np.array(init),
                           **gibbs_sampler_kwargs(j, use_pallas="full"),
                           **CPU).seed(0)
    assert port.run(32).shape == (1024, 32, 2)
    assert jax.config.jax_enable_x64  # the JAX side above is float32
    assert np.asarray(j.state.positions).dtype == np.float32
