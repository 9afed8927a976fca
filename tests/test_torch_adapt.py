"""Dual averaging (``ops/adapt.py``), ``tuned``/``warmed_up`` on HMC, MALA
and MH, and ``MALA`` in the port against the JAX package.

- ``dual_average_step_size`` in both packages on one deterministic stub
  ``step_eps`` (alpha = 1 / (1 + eps)): the tuned eps and the alpha trace
  equal at rtol 1e-6, JAX pinned to float32 (the suite enables x64) as the
  port's iterate is float32. ``exp`` and ``log`` of XLA on the CPU and of
  PyTorch differ by one ulp on about a tenth of float32 inputs, and the
  update feeds ``exp(log_eps)`` back through alpha: a stub whose alpha is
  steeper in eps (1 / (1 + 0.3 eps^2) from eps0 = 25) grows that ulp to
  1.1e-6 in the trace.
- The samplers' workflows, ported from ``tests/test_mala.py:55-160`` and
  ``tests/test_mh.py:160-226`` with their own thresholds, on the plain
  tier and the CPU twins of ``True``, ``"full"`` and ``"separable"``
  (reduced: 256 chains at most; the acceptance bands as in JAX's tests).
- The tuned step size of both packages on one configuration (MALA on a
  standard normal from eps 25, 256 chains, 400 steps) within 20%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import mala_sampler_kwargs
from mini_mcmc_torch.models import (
    Preconditioner,
    Proposal,
    Target,
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
    standard_normal,
)
from mini_mcmc_torch.ops.adapt import dual_average_step_size
from mini_mcmc_torch.ops.hmc import HMCState, hmc_kernel
from mini_mcmc_torch.runner import StepKey
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.adapt import (
    dual_average_step_size as jax_dual_average_step_size,
)

torch.set_num_threads(1)

CPU = dict(device="cpu")
TIERS = [False, True, "full", "separable"]


def _key(seed=0):
    return StepKey(seed=seed, step=0,
                   generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("eps0,target", [(0.5, 0.651), (25.0, 0.574),
                                         (0.01, 0.234)])
def test_dual_average_equals_jax_on_a_stub(eps0, target):
    n = 60
    state = HMCState(torch.zeros(4, 2), torch.zeros(4), torch.zeros(4, 2))

    def t_step(s, key, eps):
        assert key.step >= 1 and eps.dtype == torch.float32
        return s, 1.0 / (1.0 + eps)

    def j_step(s, key, eps):
        return s, 1.0 / (1.0 + eps)

    _, eps_t, trace_t = dual_average_step_size(t_step, state, _key(), n,
                                               eps0, target)
    with jax.enable_x64(False):
        _, eps_j, trace_j = jax_dual_average_step_size(
            j_step, jnp.zeros(()), jax.random.PRNGKey(0), n, eps0, target)
        trace_j = np.asarray(trace_j)
    assert trace_j.dtype == np.float32 and trace_t.dtype == torch.float32
    np.testing.assert_allclose(eps_t, eps_j, rtol=1e-6)
    np.testing.assert_allclose(trace_t.numpy(), trace_j, rtol=1e-6)


def test_dual_average_validates_n_adapt_and_keys_each_step():
    _, step_fn = hmc_kernel(standard_normal(), 0.5, 1)
    init_fn, _ = hmc_kernel(standard_normal(), 0.5, 1)
    state = init_fn(mt.init_det(4, 2, **CPU))
    for n in (0, -1):
        with pytest.raises(ValueError, match="n_adapt"):
            dual_average_step_size(step_fn.step_eps, state, _key(), n, 0.5,
                                   0.574)
    steps = []

    def record(s, key, eps):
        steps.append(key.step)
        return s, torch.tensor(0.5)

    dual_average_step_size(record, state, _key()._replace(step=7), 5, 0.5,
                           0.574)
    assert steps == [8, 9, 10, 11, 12]


def _acceptance(sampler, n_steps: int, seed: int) -> float:
    """Mean acceptance at the sampler's own step size through its
    ``step_eps`` hook (no adaptation)."""
    eps = torch.tensor(sampler.step_size, dtype=torch.float32)
    key = _key(seed)
    state, alphas = sampler.state, []
    for i in range(n_steps):
        state, a = sampler._step_fn.step_eps(state, key._replace(step=i + 1),
                                             eps)
        alphas.append(float(a))
    return float(np.mean(alphas))


@pytest.mark.parametrize("tier", TIERS)
def test_mala_tuned_reaches_target_acceptance(tier):
    mala = mt.MALA(standard_normal(), mt.init_det(256, 4, **CPU),
                   step_size=25.0, use_pallas=tier, **CPU).seed(1)
    tuned = mala.tuned(400)
    assert isinstance(tuned, mt.MALA) and tuned.n_leapfrog == 1
    assert tuned._ctor["use_pallas"] == tier
    assert abs(_acceptance(tuned, 200, 2) - 0.574) < 0.08


@pytest.mark.parametrize("tier", TIERS)
def test_hmc_tuned_reaches_target_acceptance(tier):
    target = (standard_normal() if tier == "separable"
              else diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]))
    hmc = mt.HMC(target, mt.init_det(256, 2, **CPU), 3.0, 8,
                 use_pallas=tier, steps_per_call=4, **CPU).seed(3)
    tuned = hmc.tuned(400)
    assert type(tuned) is mt.HMC and tuned._ctor["steps_per_call"] == 4
    assert abs(_acceptance(tuned, 200, 4) - 0.651) < 0.08
    assert tuned.run(8, 4).shape == (256, 8, 2)


def test_tuned_eps_of_both_packages_agree():
    x = np.asarray(mt.init_det(256, 4, **CPU))
    port = mt.MALA(standard_normal(), x, 25.0, **CPU).seed(1).tuned(400)
    jax_mala = jmt.MALA(jm.standard_normal(), jnp.asarray(x), 25.0).seed(
        1).tuned(400)
    assert abs(port.step_size / jax_mala.step_size - 1.0) < 0.2, (
        port.step_size, jax_mala.step_size)


def test_tuned_scales_with_target_stiffness():
    loose = mt.MALA(standard_normal(), mt.init_det(128, 2, **CPU), 1.0,
                    **CPU).seed(0).tuned(300)
    tight_target = diffable_gaussian2d([0.0, 0.0], [[0.01, 0.0],
                                                    [0.0, 0.01]])
    tight = mt.MALA(tight_target, mt.init_det(128, 2, **CPU) * 0.1, 1.0,
                    use_pallas="full", **CPU).seed(0).tuned(300)
    assert 5.0 < loose.step_size / tight.step_size < 20.0


def test_tuned_continues_and_is_reproducible():
    def make():
        return mt.MALA(standard_normal(), mt.init_det(8, 2, **CPU) + 50.0,
                       step_size=1.0, **CPU).seed(9)

    tuned = make().tuned(300)
    assert float(tuned.positions.abs().max()) < 25.0
    again = make().tuned(300)
    assert torch.equal(tuned.positions, again.positions)
    assert tuned.step_size == again.step_size
    # without a seed the new generator descends from the parent's
    assert torch.equal(tuned.run(20, 0), again.run(20, 0))
    rhat, _ = mt.split_rhat_mean_ess(tuned.run(500, 100))
    assert 0.9 <= float(rhat.mean()) <= 1.1
    # set_seed is seed
    a = make().set_seed(4).run(10)
    assert torch.equal(a, make().seed(4).run(10))


@pytest.mark.parametrize("tier", [False, "full"])
def test_tuned_with_metric_round_trip(tier):
    target = diffable_gaussian2d([0.0, 0.0], [[4.0, 0.0], [0.0, 0.25]])
    hmc = mt.HMC(target, mt.init_det(64, 2, **CPU), 0.2, 8, use_pallas=tier,
                 **CPU).seed(11)
    hmc.run(200, 0)
    pre = hmc.reconditioned("diag", seed=12)
    tuned = pre.tuned(200)
    # the same metric (the sampler keeps its own copy on its device)
    assert torch.equal(tuned.metric.scale, pre.metric.scale)
    # the adapted state went back to x and was whitened again
    torch.testing.assert_close(tuned.positions, pre.metric.to_x(
        tuned.state.positions))
    flat = tuned.run(1500, 200).reshape(-1, 2).double()
    assert float((flat.var(dim=0) - torch.tensor([4.0, 0.25],
                 dtype=torch.float64)).abs().max()) < 0.6


@pytest.mark.parametrize("tier", [False, True, "full"])
def test_mala_warmed_up_full_workflow(tier):
    cov = np.array([[25.0, 4.0], [4.0, 1.0]])
    target = diffable_gaussian2d([0.0, 0.0], cov)

    def ready():
        return mt.MALA(target, mt.init_det(128, 2, **CPU), step_size=1.0,
                       use_pallas=tier, **CPU).seed(21).warmed_up(300)

    w = ready()
    assert isinstance(w, mt.MALA) and w.metric is not None
    assert w.metric.kind == "diag"
    assert abs(_acceptance(w, 200, 22) - 0.574) < 0.10
    flat = w.run(2000, 200).reshape(-1, 2).double().numpy()
    assert np.max(np.abs(np.cov(flat.T) - cov) / np.abs(cov).max()) < 0.1
    assert ready().step_size == w.step_size


def _sigma_target(sigma: torch.Tensor) -> Target:
    def tile(x, s):
        return torch.sum(-0.5 * (x / s.to(x.dtype)) ** 2, dim=-1)

    return Target(logp=lambda x: tile(x, sigma), sep_form=(tile, (sigma,)),
                  cuda_functor="sigma_table_normal")


def test_separable_warmed_up_on_a_badly_scaled_target():
    # the separable stage's workflow at D=64: warmed_up(diag) whitens a
    # sigma table over two decades, the tier's twin runs the scaled form
    d, c = 64, 256
    sigma = torch.logspace(-1, 1, d)
    h = mt.HMC(_sigma_target(sigma), mt.init_with_seed(c, d, seed=2, **CPU),
               0.1, 10, use_pallas="separable", **CPU).seed(2)
    w = h.warmed_up(128, "diag")
    assert w.kernel_target.cuda_scaled and w.metric.kind == "diag"
    assert len(w.kernel_target.sep_forms()[1]) == 2
    assert abs(_acceptance(w, 32, 5) - 0.651) < 0.10
    z = w.run(128, 128, time_major=True) / sigma
    assert abs(float(z.mean())) < 0.05
    assert abs(float(z.var()) - 1.0) < 0.1


def test_reconditioned_keeps_the_class_and_mala_has_no_trajectory():
    x = mt.init_det(64, 2, **CPU)
    mala = mt.MALA(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]),
                   x, 0.8, **CPU).seed(3)
    mala.run(50, 0)
    r = mala.reconditioned("dense")
    assert isinstance(r, mt.MALA) and r.n_leapfrog == 1
    assert r.metric.kind == "dense"
    with pytest.raises(ValueError, match="n_leapfrog"):
        mala.reconditioned(n_leapfrog=4)
    # MALA is HMC with one leapfrog step, draw for draw
    a = mt.MALA(standard_normal(), x, 0.8, **CPU).seed(7).run(30, 5)
    b = mt.HMC(standard_normal(), x, 0.8, 1, **CPU).seed(7).run(30, 5)
    assert torch.equal(a, b)


def test_mala_kwargs_carry_over_from_jax():
    x = np.zeros((16, 2), np.float32)
    j = jmt.MALA(jm.standard_normal(), x, 0.7, use_pallas="full",
                 steps_per_call=4, metric=jm.Preconditioner(
                     "diag", scale=jnp.asarray([2.0, 0.5])))
    kw = mala_sampler_kwargs(j)
    assert set(kw) == {"step_size", "use_pallas", "steps_per_call", "metric",
                       "validate_dc"}
    assert kw["step_size"] == 0.7 and kw["use_pallas"] == "full"
    m = mt.MALA(standard_normal(), x, **kw, **CPU).seed(1)
    assert m.metric.kind == "diag" and m.run(8, 4).shape == (16, 8, 2)


def _move_rate(sample) -> float:
    return float((sample[:, 1:] != sample[:, :-1]).any(dim=-1).float().mean())


def _mh(std, c=256, seed=7, tier=False):
    return mt.MetropolisHastings(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        isotropic_gaussian_proposal(std), mt.init_det(c, 2, **CPU),
        use_pallas=tier, steps_per_call=2 if tier else 1, **CPU).seed(seed)


@pytest.mark.parametrize("tier", [False, "full"])
def test_mh_tuned_shrinks_and_grows_the_proposal(tier):
    small = _mh(25.0, tier=tier).tuned(400)
    assert small.scale_factor < 0.2
    assert small._ctor["use_pallas"] == tier
    # a host float reaches the kernel's parameters
    assert isinstance(small.proposal.cuda_params[0], float)
    assert 0.15 <= _move_rate(small.run(400, 50)) <= 0.32
    big = _mh(0.01, tier=tier).tuned(400)
    assert big.scale_factor > 10.0
    assert 0.15 <= _move_rate(big.run(400, 50)) <= 0.32


def test_mh_tuned_is_deterministic_and_needs_a_scaled_family():
    assert (_mh(5.0, 64, 11).tuned(200).scale_factor
            == _mh(5.0, 64, 11).tuned(200).scale_factor)
    prop = isotropic_gaussian_proposal(1.0)
    unscalable = Proposal(sample=prop.sample, logp=prop.logp)
    mh = mt.MetropolisHastings(gaussian2d([0.0, 0.0], [[1.0, 0.0],
                                                       [0.0, 1.0]]),
                               unscalable, mt.init_det(8, 2, **CPU), **CPU)
    with pytest.raises(ValueError, match="scaled"):
        mh.tuned(10)


def test_mh_tuned_cumulative_factor_and_ess():
    once = _mh(25.0, seed=3).tuned(400)
    twice = once.tuned(400)
    assert 0.5 <= twice.scale_factor / once.scale_factor <= 2.0
    assert 0.15 <= _move_rate(twice.run(400, 50)) <= 0.32
    bad = _mh(25.0, 64, 5)
    tuned = bad.tuned(400)
    _, ess_bad = mt.split_rhat_mean_ess(bad.run(500, 100))
    _, ess_tuned = mt.split_rhat_mean_ess(tuned.run(500, 100))
    assert float(ess_tuned.mean()) > 2.0 * float(ess_bad.mean())


def test_samplers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.MALA(standard_normal(), np.zeros((4, 2), np.float32), 0.5)


def test_metric_for_mala_on_the_separable_twin():
    pre = Preconditioner("diag", scale=torch.linspace(0.5, 2.0, 8))
    m = mt.MALA(standard_normal(), mt.init_with_seed(64, 8, seed=1, **CPU),
                0.5, use_pallas="separable", metric=pre, **CPU).seed(1)
    assert m.kernel_target.cuda_scaled
    assert torch.isfinite(m.run(16, 16)).all()
