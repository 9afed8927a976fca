"""Parallel tempering (``ops/tempering.py``, Kernel 8) against the JAX
package.

The port's PT step from explicit draws, fed the JAX path's own draws
(rebuilt with ``jax.random`` and the splits of
``mini_mcmc_tpu/ops/tempering.py:271-295``), equals JAX's XLA ``step_fn``
on the same state: positions and swap EWMA at float32 tolerance (rtol 1e-6,
atol 1e-6), raw logp at rtol 1e-6, parity exact. The ladder helpers equal
JAX's exactly and validate alike. Kernel 8's twin runs on CPU tensors (the
CUDA kernel is held against it in ``tests/test_torch_cuda.py``). Sampling
quality is held to the negative-control pair of
``tests/test_tempering.py:50`` on both tiers at 1,024 chains (cut from
``bench.py:858-909``'s 8,192 chains x 2,048 draws).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    pt_sampler_kwargs,
    pt_state_from_numpy,
    state_to_numpy,
)
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.pt_full import (
    make_ladder,
    pt_draws,
    pt_instance,
    pt_multistep,
    pt_multistep_plain,
)
from mini_mcmc_torch.ops.tempering import (
    PTState,
    pt_step,
    rung_logp,
    tempering_kernel,
)
from mini_mcmc_torch.runner import StepKey
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.tempering import tempering_kernel as jax_tempering

torch.set_num_threads(1)

W_PLUS = 0.7
LW_MINUS, LW_PLUS = math.log(1 - W_PLUS), math.log(W_PLUS)
GAUSS_MEAN, GAUSS_COV = [0.5, -1.0], [[2.0, 0.6], [0.6, 1.0]]


def mixture() -> Target:
    """0.3 N(-8, 0.5^2) + 0.7 N(8, 0.5^2), built as bench.py:863-880 builds
    it, naming the CUDA mixture functor."""

    def logp(x):
        a = LW_MINUS - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = LW_PLUS - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                  cuda_params=(LW_MINUS, -8.0, 0.5, LW_PLUS, 8.0, 0.5))


def jax_mixture() -> jm.Target:
    def batch(xs):
        a = jnp.log(1 - W_PLUS) - 0.5 * ((xs[:, 0] + 8.0) / 0.5) ** 2
        b = jnp.log(W_PLUS) - 0.5 * ((xs[:, 0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    return jm.Target(logp=lambda x: batch(x[None, :])[0], logp_batch=batch)


def _targets(which):
    """(JAX target, port target, D, proposal_std)."""
    if which == "mixture":
        return jax_mixture(), mixture(), 1, 1.0
    return (jm.gaussian2d(GAUSS_MEAN, GAUSS_COV),
            mt.gaussian2d(GAUSS_MEAN, GAUSS_COV), 2, [1.0, 2.0])


def _jax_draws(key, state, n_inner):
    """The draws JAX's XLA step_fn takes from ``key``
    (mini_mcmc_tpu/ops/tempering.py:271-295), as CPU tensors."""
    t, _, c = state.positions.shape
    k_inner, k_swap = jax.random.split(key)
    noises, us = [], []
    for sub in jax.random.split(k_inner, n_inner):
        k_prop, k_u = jax.random.split(sub)
        noises.append(jax.random.normal(k_prop, state.positions.shape,
                                        state.positions.dtype))
        us.append(jax.random.uniform(k_u, (t, c), state.raw_logp.dtype))
    u_swap = jax.random.uniform(k_swap, (t - 1, c), state.raw_logp.dtype)

    def tt(x):
        return torch.from_numpy(np.array(x))

    return [tt(x) for x in noises], [tt(u) for u in us], tt(u_swap)


@pytest.mark.parametrize("n_temps,n_inner,which", [
    (4, 1, "mixture"), (8, 2, "mixture"), (4, 2, "gaussian2d"),
    (8, 1, "gaussian2d")])
def test_pt_step_on_jax_draws_matches_jax_step(n_temps, n_inner, which):
    jt, tt, d, std = _targets(which)
    betas = jmt.geometric_betas(n_temps, 0.05)
    j_init, j_step = jax_tempering(jt, betas, proposal_std=std,
                                   n_inner=n_inner)
    x = np.random.default_rng(n_temps).standard_normal((64, d)) * 3.0 - 2.0
    state = j_init(jnp.asarray(x, jnp.float32))
    assert state.positions.dtype == state.raw_logp.dtype == jnp.float32
    lad = make_ladder(betas, std, d, "cpu")
    key = jax.random.PRNGKey(n_temps * 10 + n_inner)
    swapped = 0
    for _ in range(6):  # both parities, from states the steps reach
        key, sub = jax.random.split(key)
        want = j_step(state, sub)
        got = pt_step(tt, pt_state_from_numpy(state, "cpu"), lad.beta,
                      lad.sigma_l, *_jax_draws(sub, state, n_inner))
        g = state_to_numpy(got)
        np.testing.assert_allclose(g[0], np.asarray(want.positions),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[1], np.asarray(want.raw_logp),
                                   rtol=1e-6, atol=1e-6)
        assert g[2] == int(want.parity)
        np.testing.assert_allclose(g[3], np.asarray(want.swap_accept),
                                   rtol=1e-6, atol=1e-6)
        swapped += int((g[3] != state_to_numpy(
            pt_state_from_numpy(state, "cpu"))[3]).sum())
        state = want
    assert swapped > 0  # the EWMA moved: swaps were decided


def test_geometric_and_tune_betas_equal_jax():
    for n, b in ((8, 0.01), (2, 0.5), (5, 0.003)):
        assert mt.geometric_betas(n, b) == jmt.geometric_betas(n, b)
    betas = jmt.geometric_betas(6, 0.02)
    acc = [0.9, 0.5, 0.2, 0.95, 0.0]
    for n_temps in (None, 4, 9):
        want = jmt.tune_betas(betas, np.asarray(acc), n_temps=n_temps)
        assert mt.tune_betas(betas, acc, n_temps=n_temps) == want
        # a float32 EWMA, as the samplers' swap_acceptance is
        assert mt.tune_betas(betas, torch.tensor(acc), n_temps) == (
            jmt.tune_betas(betas, jnp.asarray(acc, jnp.float32), n_temps))
    # a zero-width barrier segment is nudged apart alike
    flat = (1.0, 0.5, 0.25, 0.125)
    assert mt.tune_betas(flat, [1.0, 1.0, 0.0]) == jmt.tune_betas(
        flat, [1.0, 1.0, 0.0])
    for bad in ((1, 0.01), (4, 1.5), (4, 0.0)):
        with pytest.raises(ValueError):
            jmt.geometric_betas(*bad)
        with pytest.raises(ValueError):
            mt.geometric_betas(*bad)
    for args in ((betas, acc[:3]), (betas, acc, 1)):
        with pytest.raises(ValueError):
            jmt.tune_betas(*args)
        with pytest.raises(ValueError):
            mt.tune_betas(*args)


@pytest.mark.parametrize("betas,kw,match", [
    ((1.0,), {}, ">= 2 temperatures"),
    ((0.9, 0.5), {}, "cold chain"),
    ((1.0, 1.0), {}, "strictly decreasing"),
    ((1.0, 0.5, 0.6), {}, "strictly decreasing"),
    ((1.0, 0.0), {}, "positive"),
    ((1.0, 0.5), {"n_inner": 0}, "n_inner"),
    ((1.0, 0.5), {"steps_per_call": 0}, "steps_per_call"),
    ((1.0, 0.5), {"use_pallas": True}, "full"),
])
def test_ladder_validation_raises_as_jax(betas, kw, match):
    with pytest.raises(ValueError, match=match):
        jax_tempering(jax_mixture(), betas, **kw)
    with pytest.raises(ValueError, match=match):
        tempering_kernel(mixture(), betas, **kw)
    with pytest.raises(ValueError, match=match):
        mt.ParallelTempering(mixture(), torch.zeros((4, 1)), betas=betas,
                             device="cpu", **kw)


def test_kernel_instances_and_ladder_limits():
    assert pt_instance(mixture(), 8, 1) == 3
    assert pt_instance(mt.gaussian2d(GAUSS_MEAN, GAUSS_COV), 16, 2) == 1
    with pytest.raises(ValueError, match="at most 16 rungs"):
        pt_instance(mixture(), 17, 1)
    with pytest.raises(ValueError, match=r"\(gaussian2d, D=3\)"):
        pt_instance(mt.gaussian2d(GAUSS_MEAN, GAUSS_COV), 8, 3)
    # a user density runs in a library of its own (id -1), D <= 16
    assert pt_instance(Target(logp=mixture().logp), 8, 1) == -1
    with pytest.raises(ValueError, match="D <= 16"):
        pt_instance(Target(logp=mixture().logp), 8, 17)
    lad = make_ladder((1.0, 0.25), [1.0, 3.0], 2, "cpu")
    assert lad.packed.tolist() == [1.0, 0.25, 0.75, 1.0, 3.0, 2.0, 6.0]
    with pytest.raises(ValueError, match="proposal_std"):
        make_ladder((1.0, 0.25), [1.0, 2.0, 3.0], 2, "cpu")


@pytest.mark.parametrize("dim,n_temps,n_inner", [(1, 8, 1), (2, 5, 2),
                                                   (1, 2, 3), (3, 4, 1)])
def test_pt_draws_follow_the_counter_layout(dim, n_temps, n_inner):
    """One Philox evaluation per (chain, rung, step, sweep): counter
    (c, step, t, i), words x, y the proposal normals (a Box-Muller pair),
    z the accept, w at i = 0 the swap uniform of pair (t, t+1); the twin's
    D > 2 takes normals 2p, 2p + 1 from draw p T + t."""
    seed, step, c = 0x0123456789ABCDEF, 2**31 + 9, 6
    noises, us, u_swap = pt_draws(c, n_temps, dim, n_inner, step, seed)
    assert len(noises) == len(us) == n_inner
    assert noises[0].shape == (n_temps, dim, c)
    assert us[0].shape == (n_temps, c) and u_swap.shape == (n_temps - 1, c)
    key = rng.seed_words(seed)
    for chain in range(c):
        for t in range(n_temps):
            for i in range(n_inner):
                def words(draw):
                    return [torch.tensor(int(x)) for x in rng.philox4x32_10(
                        torch.tensor([chain]), step, draw, i, key)]

                w = words(t)
                for d in range(dim):
                    p = words(d // 2 * n_temps + t)
                    want = rng.box_muller_pair(p[0], p[1])[d % 2]
                    assert torch.equal(noises[i][t, d, chain], want)
                if dim == 1:  # the kernel's cosine branch
                    assert torch.equal(noises[i][t, 0, chain],
                                       rng.box_muller(w[0], w[1]))
                assert torch.equal(us[i][t, chain], rng.unit_open(w[2]))
                if i == 0 and t + 1 < n_temps:
                    assert torch.equal(u_swap[t, chain], rng.unit_open(w[3]))


def _half_line() -> Target:
    """A half-line Gaussian: -inf outside x > 0 (test_tpu_parity.py:157)."""
    return Target(logp=lambda x: torch.where(
        x[..., 0] > 0, -0.5 * x[..., 0] ** 2,
        torch.full_like(x[..., 0], -math.inf)))


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_bounded_support_stays_nan_free_and_moves(use_pallas):
    pt = mt.ParallelTempering(_half_line(), torch.full((1024, 1), 0.5),
                              betas=mt.geometric_betas(4, 0.1),
                              proposal_std=1.0, use_pallas=use_pallas,
                              steps_per_call=16, device="cpu").seed(21)
    hs = pt.run(128, 64, time_major=True).reshape(128, -1)
    assert torch.isfinite(hs).all() and float(hs.min()) > 0.0
    assert not torch.isnan(pt.state.raw_logp).any()
    assert float((hs[1:] != hs[:-1]).float().mean()) > 0.3
    assert abs(float(hs.mean()) - math.sqrt(2 / math.pi)) < 0.05


def test_bimodal_negative_control_single_temperature_mh():
    init = torch.full((1024, 1), -8.0)
    mh = mt.MetropolisHastings(mixture(), mt.isotropic_gaussian_proposal(
        1.0), init, device="cpu").seed(1)
    assert float((mh.run(1000, 500) > 0).float().mean()) < 0.05


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_bimodal_mode_weight_recovery(use_pallas):
    calls = pt_multistep_plain.calls
    pt = mt.ParallelTempering(mixture(), torch.full((1024, 1), -8.0),
                              betas=mt.geometric_betas(8, 0.01),
                              proposal_std=1.0, use_pallas=use_pallas,
                              steps_per_call=16, device="cpu").seed(5)
    sample = pt.run(384, 384, time_major=True)
    assert sample.shape == (384, 1024, 1)
    if use_pallas:  # CPU tensors: one twin call per block, no launch
        assert pt_multistep_plain.calls == calls + 48
    w_plus = float((sample > 0).float().mean())
    assert abs(w_plus - W_PLUS) < 0.05, w_plus
    plus = sample[sample > 0].double()
    assert abs(float(plus.mean()) - 8.0) < 0.05, plus.mean()
    assert abs(float(plus.std()) - 0.5) < 0.05, plus.std()
    rates = pt.swap_acceptance
    assert rates.shape == (7,) and bool((rates > 0.05).all()), rates
    # the raw-logp cache survives the swap sweeps
    torch.testing.assert_close(pt.state.raw_logp,
                               rung_logp(pt.target, pt.state.positions))
    assert pt.n_chains == 1024 and pt.dim == 1 and pt.n_replicas == 8192
    assert pt.positions.shape == (1024, 1)


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_block_records_only_the_cold_rung(use_pallas):
    c, k = 32, 4
    tt = mt.gaussian2d(GAUSS_MEAN, GAUSS_COV)
    init_fn, step_fn = tempering_kernel(tt, (1.0, 0.5, 0.2), proposal_std=
                                        [1.0, 2.0], steps_per_call=k,
                                        use_pallas=use_pallas)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (c, 2)).astype(np.float32))
    state = init_fn(x)
    assert state.positions.shape == (3, 2, c) and state.parity == 0

    def key():
        return StepKey(seed=0xABCDEF, step=8,
                       generator=torch.Generator().manual_seed(3))

    out = torch.full((k, c, 2), math.nan)
    block = step_fn.block_fn(state, key(), out)
    s, gen_key = state, key()
    for i in range(k):
        s = step_fn(s, gen_key._replace(step=8 + i))
        assert torch.equal(out[i], s.positions[0].T)
    for a, b in zip(state_to_numpy(block), state_to_numpy(s)):
        np.testing.assert_array_equal(a, b)
    assert block.parity == k % 2


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_seeding_layouts_and_block_size(use_pallas):
    init = torch.full((64, 1), -8.0)

    def make(seed=7, k=4):
        return mt.ParallelTempering(mixture(), init, betas=(1.0, 0.3, 0.1),
                                    steps_per_call=k, use_pallas=use_pallas,
                                    device="cpu").seed(seed)

    cm = make().run(16, 8)
    assert cm.shape == (64, 16, 1)
    assert torch.equal(make().run(16, 8, time_major=True).transpose(0, 1),
                       cm)
    assert torch.equal(make(k=8).run(16, 8), cm)  # K moves no draw
    assert not torch.equal(make(8).run(16, 8), cm)
    s = make()
    first = s.run(8)
    assert torch.equal(s.positions, first[:, -1])
    with pytest.raises(ValueError, match="multiples of the block size 4"):
        s.run(6)
    # the initial positions were copied, never aliased
    assert bool((init == -8.0).all())


def test_full_tier_is_kernel_eight_twin_on_cpu():
    """On CPU tensors the fused tier is the twin: K steps of pt_step on
    the kernel's Philox draws, one call per block, no launch."""
    tt = mixture()
    init_fn, _ = tempering_kernel(tt, (1.0, 0.4))
    s = init_fn(torch.linspace(-9.0, 9.0, 16)[:, None])
    lad = make_ladder((1.0, 0.4), 1.0, 1, "cpu")
    n = pt_multistep.launches
    got = pt_multistep(tt, s.positions, s.raw_logp, s.swap_accept, 1, lad,
                       99, 5, 3, 2)
    assert pt_multistep.launches == n
    want = pt_multistep_plain(tt, s.positions, s.raw_logp, s.swap_accept, 1,
                              lad, 99, 5, 3, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_retuned_continues_the_run():
    def workflow():
        pt = mt.ParallelTempering(mixture(), torch.full((256, 1), -8.0),
                                  betas=mt.geometric_betas(6, 0.01),
                                  steps_per_call=8, device="cpu").seed(4)
        pt.run(128, 128)
        new = pt.retuned()
        return pt, new, new.run(64)

    pt, new, cube = workflow()
    assert len(new.betas) == 6 and new.betas != pt.betas
    assert new.betas[0] == 1.0 and new.betas[-1] == pt.betas[-1]
    assert new.betas == mt.tune_betas(pt.betas, pt.swap_acceptance)
    assert torch.isfinite(cube).all() and cube.shape == (256, 64, 1)
    assert torch.equal(workflow()[2], cube)  # seeded end to end
    assert len(pt.retuned(n_temps=4, seed=1).betas) == 4


def test_state_and_kwargs_carry_over_through_convert():
    x = np.random.default_rng(8).standard_normal((32, 1)).astype(np.float32)
    betas = jmt.geometric_betas(4, 0.05)
    j = jmt.ParallelTempering(jax_mixture(), jnp.asarray(x), betas=betas,
                              proposal_std=1.0, steps_per_call=4)
    kwargs = pt_sampler_kwargs(j)
    assert kwargs == dict(betas=betas, proposal_std=1.0, n_inner=1,
                          steps_per_call=4, use_pallas=False,
                          validate_dc=True)
    port = mt.ParallelTempering(mixture(), x, **kwargs, device="cpu")
    for a, b in zip(state_to_numpy(port.state),
                    state_to_numpy(pt_state_from_numpy(j.state, "cpu"))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    j.seed(1).run(8)
    carried = pt_state_from_numpy(j.state, device="cpu")
    assert isinstance(carried, PTState) and carried.parity == 0
    port.state = carried
    assert port.run(8).shape == (32, 8, 1)
    torch.testing.assert_close(port.state.raw_logp,
                               rung_logp(port.target, port.state.positions))
    fused = jmt.ParallelTempering(jax_mixture(), jnp.asarray(x),
                                  proposal_std=[1.5], use_pallas="full",
                                  n_inner=2)
    kw = pt_sampler_kwargs(fused)
    assert kw["use_pallas"] == "full" and kw["n_inner"] == 2
    assert kw["betas"] == jmt.geometric_betas(8)
    assert mt.ParallelTempering(mixture(), x, **kw, device="cpu").run(
        2).shape == (32, 2, 1)
    with pytest.raises(ValueError, match="transform"):
        mt.ParallelTempering(mixture(), x, transform=object(), device="cpu")
