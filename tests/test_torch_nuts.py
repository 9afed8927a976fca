"""The port's NUTS slice against ``mini_mcmc_tpu``'s NUTS.

Deterministic parts carry over exactly: the ``find_reasonable_epsilon ==
2.0`` golden and the depth-3 ``build_tree`` 13-tuple (reference
``nuts.rs:1050-1121``, ``tests/test_nuts.py``), and the batched epsilon
search against the JAX package's on the same numpy inputs (float64, rtol
1e-12). The samplers draw from different streams, so all three of the
port's tiers and the JAX sampler are held to ``bench_nuts``'s gates
(``bench.py:321-336``) on one numpy start state, loosened for the reduced
size as ``tests/test_nuts.py:137-160`` loosens them: 1,024 chains, 64 + 64
adaptation draws, 160 recorded draws (cut from 131,072 chains x 2,048 +
128 draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import nuts_sampler_kwargs, nuts_state_from_numpy
from mini_mcmc_torch.ops import nuts as nuts_ops
from mini_mcmc_torch.ops.nuts import (
    _LEAPFROG_SAT,
    NUTSState,
    _build_subtree,
    _finish_step,
    find_reasonable_epsilon,
    find_reasonable_epsilon_batch,
)
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.nuts import (
    find_reasonable_epsilon_batch as jax_find_eps_batch,
)

torch.set_num_threads(1)

CPU = dict(device="cpu")
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
C, N_ADAPT, N_DRAW = 1024, 64, 160


def _target():
    return mt.diffable_gaussian2d(MEAN, COV)


def _init(c=C, seed=7):
    return np.random.default_rng(seed).standard_normal((c, 2)).astype(
        np.float32)


def test_find_reasonable_epsilon_golden():
    eps = find_reasonable_epsilon(
        mt.standard_normal(), torch.tensor([0.0, 1.0], dtype=torch.float64),
        torch.tensor([1.0, 0.0], dtype=torch.float64))
    assert float(eps) == 2.0
    eps = find_reasonable_epsilon_batch(
        mt.standard_normal(),
        torch.tensor([[0.0, 1.0]], dtype=torch.float64),
        torch.tensor([[1.0, 0.0]], dtype=torch.float64))
    assert float(eps[0]) == 2.0


@pytest.mark.parametrize("name,scale", [("gaussian", 3.0),
                                        ("rosenbrock", 2.0)])
def test_find_reasonable_epsilon_batch_matches_scalar_and_jax(name, scale):
    g = np.random.default_rng(11)
    d = 2
    pos = g.standard_normal((64, d)) * scale
    mom = g.standard_normal((64, d))
    port_t, jax_t = {
        "gaussian": (_target(), jm.diffable_gaussian2d(MEAN, COV)),
        "rosenbrock": (mt.rosenbrock_nd(), jm.rosenbrock_nd()),
    }[name]
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mom)
    batched = find_reasonable_epsilon_batch(port_t, tp, tm)
    scalar = torch.stack([find_reasonable_epsilon(port_t, tp[i], tm[i])
                          for i in range(64)])
    np.testing.assert_allclose(batched.numpy(), scalar.numpy(), rtol=1e-12)
    want = jax_find_eps_batch(jax_t, jnp.asarray(pos), jnp.asarray(mom))
    np.testing.assert_allclose(batched.numpy(), np.asarray(want), rtol=1e-12)
    assert len(set(batched.tolist())) > 1


def test_build_tree_golden_deterministic():
    # reference nuts.rs:1057-1121, as tests/test_nuts.py:71: depth 3,
    # v = -1, every leaf fails the slice, so the tree draws no randomness
    f64 = dict(dtype=torch.float64)
    res = _build_subtree(
        _target(), 10, torch.tensor([0.0, 1.0], **f64),
        torch.tensor([2.0, 3.0], **f64), torch.tensor([4.0, 5.0], **f64),
        -2.0, -1, 3, 0.01, 0.1, torch.Generator().manual_seed(0))
    close = np.testing.assert_allclose
    close(res.end_pos.numpy(), [-0.1584001, 0.76208336], rtol=1e-5, atol=1e-6)
    close(res.end_mom.numpy(), [1.9800036, 2.9718253], rtol=1e-5, atol=1e-6)
    close(res.end_grad.numpy(), [-7.91236e-5, 7.9358295e-2], rtol=1e-4,
          atol=1e-6)
    close(res.prop_pos.numpy(), [-0.0198, 0.97025], rtol=1e-5, atol=1e-6)
    close(res.prop_grad.numpy(), [-1.250e-05, 9.925e-03], rtol=1e-4,
          atol=1e-7)
    assert int(res.n) == 0
    assert bool(res.s)
    assert int(res.n_alpha) == 8
    assert abs(float(res.prop_logp) - (-2.8777454)) < 1e-6
    assert abs(float(res.alpha) - 0.0006866617) < 1e-8
    assert not bool(res.diverged)


def _gates(sample, divergences_steady, n_chains):
    """bench.py:321-336 on a chain-major cube, loosened for the size."""
    sample = torch.as_tensor(np.array(sample))
    rhat, ess = mt.split_rhat_mean_ess(sample)
    mean = sample.double().mean(dim=(0, 1))
    var = sample.double().var(dim=(0, 1), unbiased=False)
    assert 0.95 <= float(rhat.mean()) <= 1.05, rhat
    assert float(ess.min()) >= 0.005 * sample.shape[0] * sample.shape[1], ess
    for d in range(2):
        assert abs(float(mean[d]) - MEAN[d]) <= 0.15, mean
        assert abs(float(var[d]) - COV[d][d]) <= 0.5, var
    assert divergences_steady <= max(1, n_chains // 10000)


def test_jax_sampler_passes_the_gates():
    j = jmt.NUTS(jm.diffable_gaussian2d(MEAN, COV),
                 jnp.asarray(_init(), jnp.float32), 0.8).seed(7)
    j.run(N_ADAPT, N_ADAPT)
    sample = j.run(N_DRAW, 0)
    _gates(sample, int(jnp.sum(j.last_run_divergences)), C)


@pytest.mark.parametrize("use_pallas", [False, True, "full"])
def test_port_tiers_pass_the_gates(use_pallas, monkeypatch):
    j = jmt.NUTS(jm.diffable_gaussian2d(MEAN, COV),
                 jnp.asarray(_init(), jnp.float32), 0.8,
                 use_pallas=use_pallas, pallas_interpret=True)
    kwargs = nuts_sampler_kwargs(j)
    assert kwargs == dict(target_accept_p=0.8, max_depth=10,
                          use_pallas=use_pallas, warmup_max_depth=None,
                          validate_dc=True)
    s = mt.NUTS(_target(), _init(), **kwargs, **CPU).seed(7)
    first = s.run(N_ADAPT, N_ADAPT)
    assert first.shape == (C, N_ADAPT, 2) and first.dtype == torch.float32
    eps = s.step_size
    assert torch.isfinite(eps).all() and (eps > 0).all()
    lf_before = s.leapfrogs.clone()
    # under "full", the 2^depth_c - 1 of each chain's own depth, per step
    want = torch.zeros(C, dtype=torch.int64)
    kernel_step = nuts_ops.nuts_step

    def counted_step(*args, **kw):
        out = kernel_step(*args, **kw)
        want.add_(2 ** out[4].to(torch.int64) - 1)
        return out

    monkeypatch.setattr(nuts_ops, "nuts_step", counted_step)
    sample = s.run(N_DRAW, 0)
    assert sample.shape == (C, N_DRAW, 2)
    assert torch.equal(sample[:, 0], first[:, -1])  # row 0: the start
    _gates(sample, int(s.last_run_divergences.sum()), C)
    # leapfrog accounting: 2^J - 1 per step, one J for all chains on the
    # lockstep tiers and each chain's own under "full"
    lf = s.last_run_leapfrogs
    assert torch.equal(lf, s.leapfrogs - lf_before)
    if use_pallas == "full":
        assert torch.equal(lf.to(torch.int64), want)
        assert not (lf == lf[0]).all()
    else:
        assert int(want.sum()) == 0  # the kernel's step is not called
        assert (lf == lf[0]).all()
    per_draw = lf.double() / (N_DRAW - 1)
    assert (per_draw >= 1.0).all() and (per_draw <= 2.0**10).all()
    assert float(per_draw.mean()) < 31.0  # a 2D Gaussian needs short trees


def test_state_carries_over_from_the_jax_sampler():
    j = jmt.NUTS(jm.diffable_gaussian2d(MEAN, COV),
                 jnp.asarray(_init(64), jnp.float32), 0.8).seed(1)
    j.run(20, 20)
    s = mt.NUTS(_target(), _init(64), **nuts_sampler_kwargs(j), **CPU)
    s.state = nuts_state_from_numpy(j.state, **CPU)
    assert s.state.m == 39 and s.state.n_discard == 20
    np.testing.assert_array_equal(s.state.epsilon.numpy(),
                                  np.asarray(j.state.epsilon))
    np.testing.assert_array_equal(s.positions.numpy(),
                                  np.asarray(j.positions))
    before = s.leapfrogs.clone()
    out = s.run(16, 0)
    assert torch.equal(out[:, 0], torch.from_numpy(np.array(j.positions)))
    assert s.state.m == 39 + 15
    # adaptation is over: the step size is frozen to the JAX epsilon_bar
    np.testing.assert_allclose(s.step_size.numpy(),
                               np.asarray(j.state.epsilon_bar), rtol=1e-6)
    assert (s.leapfrogs > before).all()


@pytest.mark.parametrize("use_pallas", [False, True, "full"])
def test_layouts_seeding_and_conventions(use_pallas):
    init = torch.from_numpy(_init(64, seed=2))

    def make(seed=5):
        return mt.NUTS(_target(), init, 0.8, use_pallas=use_pallas,
                       **CPU).seed(seed)

    cm = make().run(12, 6)
    assert cm.shape == (64, 12, 2)
    tm = make().run(12, 6, time_major=True)
    assert torch.equal(tm.transpose(0, 1), cm)
    assert torch.equal(make().run(12, 6), cm)
    assert not torch.equal(make(6).run(12, 6), cm)
    s = make()
    first = s.run(5, 0)
    assert torch.equal(first[:, 0], init)  # row 0 is the initial position
    assert s.state.m == 4  # n_collect + n_discard - 1 steps
    assert torch.equal(s.positions, first[:, -1])
    s.run(3, 4)
    assert s.state.m == 4 + 6
    assert torch.equal(init, torch.from_numpy(_init(64, seed=2)))  # no alias


@pytest.mark.parametrize("use_pallas", [False, True, "full"])
def test_chain_isolation_under_masking(use_pallas):
    # tests/test_nuts.py:214: a chain's draws and decisions do not depend
    # on what the other chains do (here chain 1 diverges at once)
    init = torch.tensor([[0.3, 1.2], [0.5, -0.4]])

    def run(eps1):
        s = mt.NUTS(_target(), init, 0.8, use_pallas=use_pallas,
                    **CPU).seed(9)
        s.state = s.state._replace(epsilon=torch.tensor([0.5, eps1]))
        s._prepare_fn = lambda st, key, n_discard: st._replace(n_discard=0)
        return s.run(8, 0), s

    normal, _ = run(0.5)
    partner_diverges, s = run(1e6)
    assert int(s.divergences[1]) > 0
    assert torch.equal(normal[0], partner_diverges[0])


def test_divergence_counters_per_run():
    s = mt.NUTS(mt.rosenbrock_nd(), torch.zeros((4, 2)), 0.8, max_depth=4,
                **CPU).seed(0)
    assert int(s.last_run_divergences.sum()) == 0
    s.state = s.state._replace(epsilon=torch.full((4,), 10.0),
                               epsilon_bar=torch.full((4,), 10.0))
    s._prepare_fn = lambda st, key, n_discard: st
    s.run(20, 0)
    burst = int(s.last_run_divergences.sum())
    assert burst > 0 and int(s.divergences.sum()) == burst
    s.state = s.state._replace(epsilon=torch.full((4,), 1e-3),
                               epsilon_bar=torch.full((4,), 1e-3))
    s.run(20, 0)
    assert int(s.last_run_divergences.sum()) == 0
    assert int(s.divergences.sum()) == burst


def test_leapfrog_counter_saturates():
    c = 4
    f = torch.float32

    def bump(lf, inc):
        st = NUTSState(torch.zeros((c, 2)), torch.full((c,), 0.5),
                       torch.ones((c,)), torch.zeros((c,)), torch.zeros((c,)),
                       5, 0, torch.zeros((c,), dtype=torch.int32),
                       torch.full((c,), lf, dtype=torch.int32))
        out = _finish_step(st, 0.8, 6, st.positions, torch.ones((c,), dtype=f),
                           torch.ones((c,), dtype=torch.int32),
                           torch.zeros((c,), dtype=torch.bool), inc)
        return out.leapfrogs

    assert (bump(100, 1023) == 1123).all()
    assert (bump(_LEAPFROG_SAT - 10, 1023) == _LEAPFROG_SAT).all()
    assert (bump(_LEAPFROG_SAT, 1023) == _LEAPFROG_SAT).all()
    assert (bump(-1, 1023) == -1).all()
    assert bump(10, torch.tensor([1, 3, 7, 15])).tolist() == [11, 13, 17, 25]


def test_constructor_validation_and_device_default():
    t = _target()
    x = _init(8)
    with pytest.raises(ValueError, match="warmup_max_depth"):
        mt.NUTS(t, x, 0.8, warmup_max_depth=0, **CPU)
    with pytest.raises(ValueError, match="warmup_max_depth"):
        mt.NUTS(t, x, 0.8, max_depth=6, warmup_max_depth=7, **CPU)
    with pytest.raises(ValueError, match="metric must be a Preconditioner"):
        mt.NUTS(t, x, 0.8, metric=object(), **CPU)
    with pytest.raises(ValueError, match="transform"):
        mt.NUTS(t, x, 0.8, transform=object(), **CPU)
    with pytest.raises(ValueError, match="use_pallas"):
        mt.NUTS(t, x, 0.8, use_pallas="separable", **CPU)
    with pytest.raises(ValueError, match=r"\[n_chains, dim\]"):
        mt.NUTS(t, x[0], 0.8, **CPU)
    # a warm-up cap still samples
    capped = mt.NUTS(t, _init(64), 0.8, warmup_max_depth=3, **CPU).seed(3)
    capped.run(32, 32)
    assert torch.isfinite(capped.positions).all()
    # the entry points run on the card unless asked for the CPU
    for make in (lambda: mt.NUTS(t, x, 0.8),
                 lambda: mt.HMC(mt.rosenbrock_nd(), _init(8, 3), 0.02, 4),
                 lambda: mt.init_with_seed(8, 2, seed=1),
                 lambda: nuts_state_from_numpy(mt.NUTS(t, x, **CPU).state)):
        if torch.cuda.is_available():
            assert make() is not None
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
