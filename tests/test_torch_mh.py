"""Metropolis-Hastings in the port against the JAX package.

- Densities and proposal densities on the same numpy inputs: float32
  tolerance (rtol 1e-6; both sides evaluate one formula in float32, the
  JAX side pinned to float32 since the suite enables x64).
- One step on identical draws: the JAX package's chains-on-lanes forms
  (``propose_dc``, ``logp_dc``, the strict accept of
  ``mini_mcmc_tpu/ops/pallas/mh_full.py:91-96``) fed a namespace of fixed
  draws in place of the TPU stream, against Kernel 5's plain twin fed the
  word stream those draws come from: positions equal, logp equal
  (Poisson: within rtol 1e-6 of the JAX XLA form, whose ``lax.lgamma``
  is XLA's own approximation, a few float32 ulps from ``torch.lgamma``:
  it gives ``lgamma(1) = 4.8e-7``).
- The word stream's layout: one step of the twin at the last chain index
  and a step past 2**31 equals one hand-computed from ``rng.philox_words``.
- The twin's draws depend only on (key, chain, global step).
- The samplers on the CPU, both tiers, beside ``mini_mcmc_tpu``'s
  ``use_pallas=False`` sampler from the same numpy start, under the gates
  of ``tests/test_mh.py:45-99`` at reduced sizes (64 chains x 1,000 draws
  after 250 for the Gaussians, cut from 8 x 4,000 after 1,000; 64 x 2,000
  after 500 for the discrete targets, cut from 4 x 10,000 after 2,000).
"""

import doctest
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import binom, poisson

import mini_mcmc_torch as mt
import mini_mcmc_torch.samplers
from mini_mcmc_torch.convert import (
    mh_sampler_kwargs,
    mh_state_from_numpy,
    state_to_numpy,
)
from mini_mcmc_torch.models import (
    Categorical,
    Proposal,
    Target,
    binomial_target,
    gaussian2d,
    gaussian_random_walk_proposal,
    isotropic_gaussian_proposal,
    isotropic_gaussian_target,
    poisson_target,
    random_walk_int_proposal,
)
from mini_mcmc_torch.ops.kernels import _build, rng
from mini_mcmc_torch.ops.kernels.mh_full import (
    PROPOSE_FROM_WORDS,
    mh_instance,
    mh_multistep,
    mh_multistep_plain,
)
from mini_mcmc_torch.ops.mh import mh_kernel, mh_step_alpha
from mini_mcmc_torch.runner import StepKey
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm

torch.set_num_threads(1)

RTOL = 1e-6
MEAN, COV = [2.0, 3.0], [[4.0, 2.0], [2.0, 3.0]]
CPU = dict(device="cpu")


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def _points(c=64, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((c, 2)) * 2.0 + MEAN).astype(np.float32)


def _ints(c=64, seed=0, lo=-3, hi=14):
    g = np.random.default_rng(seed)
    return g.integers(lo, hi, (c, 1)).astype(np.int32)


# -- (a) densities on identical inputs ---------------------------------------


def test_gaussian2d_matches_jax():
    x = _points()
    jt = jm.gaussian2d(MEAN, COV)
    t = gaussian2d(MEAN, COV)
    # the chains-on-lanes form term for term: equal
    np.testing.assert_array_equal(
        t.batch_logp(torch.from_numpy(x)).numpy(),
        np.asarray(jt.logp_dc(jnp.asarray(x.T)), np.float32))
    jx = jnp.asarray(x, jnp.float32)
    _close(t.batch_logp(torch.from_numpy(x)), jt.batch_logp(jx), 1e-5)
    want_norm = np.array([jt.logp_normalized(r) for r in jx], np.float32)
    _close(t.logp_normalized(torch.from_numpy(x)), want_norm, 1e-5)
    assert t.cuda_functor == "gaussian2d" and t.cuda_params[-1] == 0.0
    _close(isotropic_gaussian_target(1.5).logp(torch.from_numpy(x)),
           np.array([jm.isotropic_gaussian_target(1.5).logp(r) for r in jx]))


@pytest.mark.parametrize("make", [
    lambda m: m.poisson_target(4.0),
    lambda m: m.binomial_target(10, 0.3),
    lambda m: m.Categorical([0.1, 0.2, 0.3, 0.15, 0.25]).target(),
], ids=["poisson", "binomial", "categorical"])
def test_discrete_targets_match_jax_on_int32_states(make):
    k = _ints(lo=-3, hi=14)  # includes k < 0 and k > n
    want = np.asarray(make(jm).batch_logp(jnp.asarray(k)))
    got = make(mt.models).batch_logp(torch.from_numpy(k))
    assert got.dtype == torch.float32
    finite = np.isfinite(want)
    assert (~finite).any() and finite.any()
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    assert np.all(got.numpy()[~finite] == -np.inf)
    _close(got.numpy()[finite], want[finite])


def test_categorical_logp_and_sample():
    probs = [1.0, 3.0, 6.0]
    jc, c = jm.Categorical(probs), Categorical(probs)
    idx = np.array([-1, 0, 1, 2, 3], np.int32)
    want = np.asarray(jc.logp(jnp.asarray(idx)))
    got = c.logp(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    _close(got[1:4], want[1:4])
    draws = c.sample(torch.Generator().manual_seed(0), (20000,))
    freq = torch.bincount(draws, minlength=3).double() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.3, 0.6], atol=0.015)


def test_proposal_densities_match_jax():
    g = np.random.default_rng(3)
    a = g.standard_normal((32, 3)).astype(np.float32)
    b = (a + g.standard_normal((32, 3))).astype(np.float32)
    for make in (lambda m: m.isotropic_gaussian_proposal(0.7),
                 lambda m: m.gaussian_random_walk_proposal([0.5, 1.0, 2.0])):
        jp, p = make(jm), make(mt.models)
        want = np.array([jp.logp(jnp.asarray(x), jnp.asarray(y))
                         for x, y in zip(a, b)])
        _close(p.logp(torch.from_numpy(a), torch.from_numpy(b)), want, 1e-5)
    k, k2 = _ints(seed=1, lo=0, hi=9), _ints(seed=2, lo=0, hi=9)
    jp, p = jm.random_walk_int_proposal(), random_walk_int_proposal()
    want = np.array([jp.logp(jnp.asarray(x), jnp.asarray(y))
                     for x, y in zip(k, k2)])
    _close(p.logp(torch.from_numpy(k), torch.from_numpy(k2)), want)
    # declared symmetry: the reference's quirk, kept
    assert p.symmetric and isotropic_gaussian_proposal(1.0).symmetric
    assert not gaussian_random_walk_proposal([1.0]).symmetric


# -- (b) one step on identical draws -----------------------------------------


class _FixedDraws:
    """The JAX package's in-kernel rng namespace (ops/pallas/rng.py) with
    fixed arrays in place of the TPU hardware stream."""

    def __init__(self, normals=None, uniform=None, bits=None):
        self._d = dict(normals=normals, uniform=uniform, bits=bits)

    def _take(self, name, shape):
        arr = self._d[name]
        assert arr.shape == tuple(shape), (name, arr.shape, shape)
        return jnp.asarray(arr)

    def normals(self, shape):
        return self._take("normals", shape)

    def uniform(self, shape):
        return self._take("uniform", shape)

    def random_bits(self, shape):
        return self._take("bits", shape)


def _words(c, n_words, seed=0xC0FFEE, step=5):
    """One step's word streams, int64 [1, C, W] (a block of K=1)."""
    return rng.stream_words(c, n_words, step, seed)[None]


def _jax_mh_step(logp_of, propose_dc, pos_dc, logp, fixed):
    """The body of mh_full.py:89-100 on the CPU with fixed draws."""
    prop = propose_dc(fixed, pos_dc)
    lp = logp_of(prop)
    u = fixed.uniform(lp.shape)
    accept = (lp - logp) > jnp.log(u)
    return (jnp.where(accept[None], prop, pos_dc),
            jnp.where(accept, lp, logp), np.asarray(accept))


def test_one_gaussian_step_equals_jax_on_identical_draws():
    c, d = 512, 2
    x = _points(c, seed=4)
    jt, jp = jm.gaussian2d(MEAN, COV), jm.isotropic_gaussian_proposal(1.5)
    t, p = gaussian2d(MEAN, COV), isotropic_gaussian_proposal(1.5)
    w = _words(c, d + 1)
    fixed = _FixedDraws(normals=rng.pair_normals(w[0], d).numpy().T,
                        uniform=rng.unit_open(w[0, :, d]).numpy())
    pos_dc = jnp.asarray(x.T)
    jlogp = jt.logp_dc(pos_dc)
    want_pos, want_lp, accept = _jax_mh_step(jt.logp_dc, jp.propose_dc,
                                             pos_dc, jlogp, fixed)
    assert 0.05 < accept.mean() < 0.95
    tx = torch.from_numpy(x)
    tlogp = t.batch_logp(tx)
    np.testing.assert_array_equal(tlogp.numpy(), np.asarray(jlogp))
    pos, logp = mh_multistep_plain(t, p, tx, tlogp, 0, 0, 1, words=w)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos).T)
    np.testing.assert_array_equal(logp.numpy(), np.asarray(want_lp))


@pytest.mark.parametrize("clip_high", [None, 6])
def test_one_int_walk_step_equals_jax_on_identical_draws(clip_high):
    c = 512
    k = _ints(c, seed=5, lo=0, hi=7)
    jt, jp = jm.poisson_target(4.0), jm.random_walk_int_proposal(0, clip_high)
    t, p = poisson_target(4.0), random_walk_int_proposal(0, clip_high)
    w = _words(c, 2)
    bits = (w[0, :, :1].numpy().astype(np.uint32).view(np.int32)).T
    fixed = _FixedDraws(bits=bits, uniform=rng.unit_open(w[0, :, 1]).numpy())

    def xla_logp(pos_dc):  # the JAX XLA form (lax.lgamma), per chain
        return jt.batch_logp(pos_dc.T)

    pos_dc = jnp.asarray(k.T)
    jlogp = xla_logp(pos_dc)
    want_pos, want_lp, accept = _jax_mh_step(xla_logp, jp.propose_dc,
                                             pos_dc, jlogp, fixed)
    assert 0.05 < accept.mean() < 0.95
    tk = torch.from_numpy(k)
    pos, logp = mh_multistep_plain(t, p, tk, t.batch_logp(tk), 0, 0, 1,
                                   words=w)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos).T)
    if clip_high is not None:
        assert int(pos.max()) <= clip_high and int(pos.min()) >= 0
    _close(logp, want_lp)  # see the docstring


def test_fused_step_rejects_minus_inf_and_keeps_state_finite():
    """A proposal into -inf is rejected by true selects; a chain that
    starts at -inf moves to the first finite proposal."""
    base = gaussian2d(MEAN, COV)

    def logp(p):
        return torch.where(p[..., 0] < 2.5, base.logp(p),
                           torch.tensor(-math.inf))

    t = Target(logp=logp)
    x = torch.tensor([[2.49, 3.0], [8.0, 3.0]])
    w = _words(2, 3)
    # chain 0 steps right across the wall, chain 1 left back below it: x's
    # normal is the cosine of the Box-Muller pair on words 0 and 1
    w[0, :, 0] = torch.tensor([0, 0])
    w[0, :, 1] = torch.tensor([0, 2**31])
    lp0 = t.batch_logp(x)
    assert lp0[1] == -math.inf
    pos, logp = mh_multistep_plain(t, isotropic_gaussian_proposal(1.0), x,
                                   lp0, 0, 0, 1, words=w)
    assert torch.equal(pos[0], x[0]) and logp[0] == lp0[0]
    assert pos[1, 0] < 2.5 and torch.isfinite(logp[1])


SEED_PIN = 0x1234_5678_9ABC_DEF0
CHAIN_PIN = 2**32 - 4  # chains 2**32 - 4 .. 2**32 - 1
STEP_PIN = 2**31 + 11


def _hand_stream(chain, n_words):
    """The word stream of (chain, STEP_PIN) on Python ints: the words of
    the counters (chain, step, q, 0), q = 0, 1, ..., in order."""
    out = []
    for q in range((n_words + 3) // 4):
        out += rng.philox_words(chain, STEP_PIN, q, 0, SEED_PIN)
    return out


@pytest.mark.parametrize("which,dim,evals", [
    ("gauss2d", 2, 1), ("rosenbrock", 2, 1), ("rosenbrock", 3, 2),
    ("poisson", 1, 1)])
def test_one_step_follows_the_word_stream_layout(which, dim, evals):
    """One step of the twin at the last chains and a step past 2**31
    equals a step hand-computed from rng.philox_words: normals 2p, 2p + 1
    from the Box-Muller pair on words 2p, 2p + 1 and the accept from word
    2 ceil(D / 2); the integer walk's coin from word 0's top bit and the
    accept from word 1. A step takes ``evals`` Philox evaluations."""
    if which == "poisson":
        t, p = poisson_target(4.0), random_walk_int_proposal()
        x = torch.tensor([[0], [3], [4], [9]], dtype=torch.int32)
    else:
        t = gaussian2d(MEAN, COV) if which == "gauss2d" else mt.rosenbrock_nd()
        p = isotropic_gaussian_proposal(0.5)
        x = torch.from_numpy(_points(4, seed=dim)[:, :1].repeat(dim, 1) / 3)
    words_of, _ = PROPOSE_FROM_WORDS[p.cuda_functor]
    n_words = words_of(dim) + 1
    assert (n_words + 3) // 4 == evals
    streams = [_hand_stream(ch, n_words) for ch in range(CHAIN_PIN,
                                                           CHAIN_PIN + 4)]
    if which == "poisson":
        coins = torch.tensor([[1 if w[0] < 2**31 else -1] for w in streams])
        prop = (x + coins).clamp(min=0).to(torch.int32)
    else:
        normals = []
        for w in streams:
            n = []
            for q in range((dim + 1) // 2):
                n += rng.box_muller_pair(torch.tensor(w[2 * q]),
                                         torch.tensor(w[2 * q + 1]))
            normals.append(torch.stack(n[:dim]))
        prop = x + p.cuda_params[0] * torch.stack(normals)
    u = rng.unit_open(torch.tensor([w[n_words - 1] for w in streams]))
    lp, lpp = t.batch_logp(x), t.batch_logp(prop)
    accept = (lpp - lp) > torch.log(u)
    pos, logp = mh_multistep_plain(t, p, x, lp, SEED_PIN, STEP_PIN, 1,
                                   chain0=CHAIN_PIN)
    assert torch.equal(pos, torch.where(accept[:, None], prop, x))
    assert torch.equal(logp, torch.where(accept, lpp, lp))


# -- (c) the twin's draws depend on (key, chain, global step) only -----------


@pytest.mark.parametrize("which", ["gauss", "poisson"])
def test_twin_cube_does_not_depend_on_blocks_or_chain_split(which):
    if which == "gauss":
        t, p = gaussian2d(MEAN, COV), isotropic_gaussian_proposal(1.0)
        x = torch.from_numpy(_points(64, seed=6))
    else:
        t, p = poisson_target(4.0), random_walk_int_proposal()
        x = torch.from_numpy(_ints(64, seed=6, lo=0, hi=8))
    lp = t.batch_logp(x)
    seed, k = 0xABCDEF0123, 16
    one = torch.empty((k,) + tuple(x.shape), dtype=x.dtype)
    a = mh_multistep(t, p, x, lp, seed, 100, k, one)
    steps = torch.empty_like(one)
    s = (x, lp)
    for i in range(k):
        s = mh_multistep(t, p, *s, seed, 100 + i, 1, steps[i:i + 1])
    halves = torch.empty_like(one)
    h = [mh_multistep(t, p, x[sl], lp[sl], seed, 100, k, halves[:, sl],
                      chain0=sl.start) for sl in (slice(0, 32),
                                                  slice(32, 64))]
    assert torch.equal(one, steps) and torch.equal(one, halves)
    for got in (s, tuple(torch.cat(v) for v in zip(*h))):
        assert torch.equal(a[0], got[0]) and torch.equal(a[1], got[1])
    assert (one[1:] != one[:-1]).any()  # the chains moved
    other = torch.empty_like(one)
    mh_multistep(t, p, x, lp, seed + 1, 100, k, other)
    assert not torch.equal(one, other)


# -- (d) the samplers on the CPU, beside the JAX sampler ---------------------


def _moments(sample):
    flat = np.asarray(sample, np.float64).reshape(-1, sample.shape[-1])
    return flat.mean(axis=0), np.cov(flat.T)


def _both(target_of, proposal_of, init, use_pallas, n, burn, seed, k=1):
    """The port's sampler and the JAX package's (use_pallas=False) from
    the same numpy start."""
    port = mt.MetropolisHastings(
        target_of(mt.models), proposal_of(mt.models), init,
        use_pallas=use_pallas, steps_per_call=k, **CPU).seed(seed)
    jax = jmt.MetropolisHastings(target_of(jm), proposal_of(jm),
                                 jnp.asarray(init)).seed(seed)
    return port.run(n, burn), np.asarray(jax.run(n, burn))


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_gaussian_moments_and_negative_control(use_pallas):
    init = _points(64, seed=7)
    sample, jsample = _both(lambda m: m.gaussian2d(MEAN, COV),
                            lambda m: m.isotropic_gaussian_proposal(2.0),
                            init, use_pallas, 1000, 250, seed=7, k=50)
    assert sample.shape == (64, 1000, 2) and sample.dtype == torch.float32
    for s in (sample.numpy(), jsample):
        m, c = _moments(s)
        assert np.all(np.abs(m - MEAN) < 0.5), m
        assert np.max(np.abs(c - np.asarray(COV))) < 0.5, c
    # negative control (metrohast_2d_gaussian_test.rs:84-91)
    wrong = mt.MetropolisHastings(
        gaussian2d([0.0, 0.0], [[6.0, 2.0], [2.0, 5.0]]),
        isotropic_gaussian_proposal(2.0), init, use_pallas=use_pallas,
        steps_per_call=50, **CPU).seed(11)
    _, c = _moments(wrong.run(1000, 250).numpy())
    assert np.max(np.abs(c - np.eye(2))) > 1.0


@pytest.mark.parametrize("use_pallas", [False, "full"])
@pytest.mark.parametrize("which", ["poisson", "binomial"])
def test_discrete_frequencies_and_int32_states(use_pallas, which):
    if which == "poisson":
        pmf = [poisson.pmf(k, 4.0) for k in range(11)]
        target_of = (lambda m: m.poisson_target(4.0))
        proposal_of = (lambda m: m.random_walk_int_proposal())
        init = np.zeros((64, 1), np.int32)
    else:
        pmf = [binom.pmf(k, 10, 0.3) for k in range(11)]
        target_of = (lambda m: m.binomial_target(10, 0.3))
        proposal_of = (lambda m: m.random_walk_int_proposal(0, 10))
        init = np.full((64, 1), 5, np.int32)
    sample, jsample = _both(target_of, proposal_of, init, use_pallas, 2000,
                            500, seed=42, k=100)
    assert sample.dtype == torch.int32
    for s in (sample.numpy().ravel(), jsample.ravel()):
        freq = np.array([np.mean(s == k) for k in range(11)])
        assert np.max(np.abs(freq - pmf)) < 0.05, freq


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_runs_continue_and_seeds_reproduce(use_pallas):
    init = _points(16, seed=8)

    def make(seed=3, k=4):
        return mt.MetropolisHastings(
            gaussian2d(MEAN, COV), isotropic_gaussian_proposal(1.0), init,
            use_pallas=use_pallas, steps_per_call=k, **CPU).seed(seed)

    s = make()
    first = s.run(16, 0)
    assert torch.equal(s.positions, first[:, -1])
    second = s.run(16, 0)
    assert not torch.equal(second[:, 0], first[:, 0])
    cm = make().run(16, 8)
    assert torch.equal(make().run(16, 8, time_major=True).transpose(0, 1),
                       cm)
    assert not torch.equal(make(4).run(16, 8), cm)
    if use_pallas:  # the fused stream does not depend on K
        assert torch.equal(make(k=1).run(16, 8), cm)
    assert torch.equal(torch.from_numpy(init), torch.from_numpy(
        _points(16, seed=8)))  # copied, never aliased


def test_constructor_validation():
    init = _points(8)
    t = gaussian2d(MEAN, COV)
    with pytest.raises(ValueError, match='use_pallas="full"'):
        mt.MetropolisHastings(t, isotropic_gaussian_proposal(1.0), init,
                              use_pallas=True, **CPU)
    with pytest.raises(ValueError, match="symmetric"):
        mt.MetropolisHastings(t, gaussian_random_walk_proposal([1.0, 1.0]),
                              init, use_pallas="full", **CPU)
    walk = isotropic_gaussian_proposal(1.0)
    no_form = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True)
    with pytest.raises(ValueError, match="propose_words"):
        mt.MetropolisHastings(t, no_form, init, use_pallas="full", **CPU)
    with pytest.raises(ValueError, match="transform"):
        mt.MetropolisHastings(t, walk, init, transform=object(), **CPU)
    with pytest.raises(ValueError, match="steps_per_call"):
        mt.MetropolisHastings(t, walk, init, steps_per_call=0, **CPU)
    # the plain tier takes any proposal, the fused one any target on CPU
    plain_target = Target(logp=t.logp)
    for s in (mt.MetropolisHastings(t, no_form, init, **CPU),
              mt.MetropolisHastings(plain_target, walk, init,
                                    use_pallas="full", **CPU)):
        assert s.run(4).shape == (8, 4, 2)


def test_kernel_instances_are_named_in_errors():
    t, p = poisson_target(4.0), isotropic_gaussian_proposal(1.0)
    with pytest.raises(ValueError, match=r"\(poisson, random_walk_int, "
                       r"int32, D=1\)"):
        mh_instance(t, p, torch.float32, 1)
    # an int32 user density runs in a library of its own; float64 states
    # raise, naming what each tier takes
    assert mh_instance(Target(logp=t.logp), random_walk_int_proposal(),
                       torch.int32, 1) == (-1, -1, 1)
    with pytest.raises(ValueError, match="does not take float64"):
        mh_instance(Target(logp=t.logp), random_walk_int_proposal(),
                    torch.float64, 1)
    assert mh_instance(gaussian2d(MEAN, COV), p, torch.float32, 2) == (
        1, 0, 0)
    assert mh_instance(t, random_walk_int_proposal(), torch.int32, 1) == (
        2, 1, 1)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        random_walk_int_proposal(0, 1 << 25)


@pytest.mark.parametrize("time_major", [True, False])
def test_hist_args_take_a_block_of_either_cube_layout(time_major):
    k, c, d = 4, 8, 2
    cpu = torch.device("cpu")
    if time_major:
        view = torch.zeros((16, c, d), dtype=torch.int32)[4:8]
    else:
        view = torch.zeros((c, 16, d), dtype=torch.int32)[:, 4:8]
        view = view.transpose(0, 1)
    assert _build.hist_args(view, k, c, d, torch.int32, cpu) == (
        view.data_ptr(), view.stride(0), view.stride(1))
    assert _build.hist_args(None, k, c, d, torch.int32, cpu) == (None, 0, 0)
    strided_d = torch.zeros((k, d, c), dtype=torch.int32).transpose(1, 2)
    for bad in (view.float(), view[:, :4], strided_d):
        with pytest.raises(ValueError, match=r"hist must be a int32 "
                           r"\[4, 8, 2\] view on cpu with unit D stride"):
            _build.hist_args(bad, k, c, d, torch.int32, cpu)


def test_step_alpha_hook():
    init_fn, _ = mh_kernel(gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                           isotropic_gaussian_proposal(1.0))
    state = init_fn(torch.from_numpy(_points(256, seed=9)) - 2.0)
    step = mh_step_alpha(gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                         isotropic_gaussian_proposal(1.0).scaled)
    key = StepKey(0, 0, torch.Generator().manual_seed(0))
    _, small = step(state, key, 0.01)
    _, large = step(state, key, 30.0)
    assert 0.9 < float(small) <= 1.0 and 0.0 <= float(large) < 0.1


def test_sampler_docstring_example():
    results = doctest.testmod(mini_mcmc_torch.samplers, verbose=False)
    assert results.attempted >= 1 and results.failed == 0, results


# -- (e) convert -------------------------------------------------------------


def test_mh_state_round_trip_keeps_int32():
    j = jmt.MetropolisHastings(jm.poisson_target(4.0),
                               jm.random_walk_int_proposal(),
                               jnp.asarray(_ints(8, lo=0, hi=8))).seed(1)
    j.run(10, 0)
    state = mh_state_from_numpy(*(np.asarray(x) for x in j.state), **CPU)
    assert state.positions.dtype == torch.int32
    assert state.logp.dtype == torch.float32
    for a, b in zip(state_to_numpy(state), j.state):
        np.testing.assert_array_equal(a, np.asarray(b))
    s = mt.MetropolisHastings(poisson_target(4.0),
                              random_walk_int_proposal(), state.positions,
                              **CPU).seed(2)
    s.state = state
    assert s.run(5).dtype == torch.int32
    f = mh_state_from_numpy(np.zeros((2, 2)), np.zeros(2), **CPU)
    assert f.positions.dtype == torch.float32


def test_mh_sampler_kwargs_drops_jax_only_keys():
    j = jmt.MetropolisHastings(jm.gaussian2d(MEAN, COV),
                               jm.isotropic_gaussian_proposal(1.0),
                               jnp.asarray(_points(8)), steps_per_call=4)
    kw = mh_sampler_kwargs(j)
    assert kw == dict(use_pallas=False, steps_per_call=4, validate_dc=True)
    s = mt.MetropolisHastings(gaussian2d(MEAN, COV),
                              isotropic_gaussian_proposal(1.0), _points(8),
                              **kw, **CPU)
    assert s.run(8).shape == (8, 8, 2)
    ctor = dict(kw, pallas_interpret=True, validate_dc=False,
                transform=object())
    with pytest.raises(ValueError, match="transform"):
        mh_sampler_kwargs(SimpleNamespace(_ctor=ctor))
