"""``mini_mcmc_torch.checkpoint`` on the CPU: save and restore of every
sampler, and its guards held against the JAX package's.

- The cases of tests/test_checkpoint.py on the port: bit-exact resume for
  MH, HMC, Gibbs, NUTS with its adaptation, and an HMC with a dense metric
  with its three mismatch guards. The orbax, npz and mesh cases become:
  the default writes ``<path>.pt`` only, ``backend="orbax"``/``"npz"``
  raise ``ValueError``, and a checkpoint saved on the CPU loads with
  ``device="cpu"``; the ``leapfrogs`` migration becomes "an unknown
  format version raises" (no port checkpoint predates the format).
- The resume cases of test_chees.py, test_ensemble.py, test_slice.py,
  test_elliptical.py, test_tempering.py, test_sgmcmc.py and
  test_transforms.py, on the port.
- Every sampler on every tier (the fused tiers through their plain
  twins) continues bit for bit after ``save_sampler`` and
  ``restore_sampler`` into a sampler built with another seed.
- Guard parity: the same mismatches (metric kind, metric array, a metric
  against none either way, transform name, a transform against none,
  same-named custom bijectors, chain count) raise ``ValueError`` in both
  packages, and the matching sampler restores in both.
- A JAX state read through ``convert.*_state_from_numpy``, saved and
  loaded by the port, gives back the same fields exactly.
- The two ADVICE.md faults of the JAX module are not copied: the probe
  keeps five significant digits, and its cache holds bijectors weakly.

Comparisons are exact (``torch.equal``) throughout: a resumed chain draws
the same words from the same generator state.
"""

import functools
import gc
import os
import re
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch import checkpoint as ck
from mini_mcmc_torch import convert
from mini_mcmc_torch.checkpoint import (
    load_checkpoint,
    restore_sampler,
    save_checkpoint,
    save_sampler,
)
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.models.transforms import Bijector
from mini_mcmc_tpu import HMC as JaxHMC
from mini_mcmc_tpu import NUTS as JaxNUTS
from mini_mcmc_tpu import SGLD as JaxSGLD
from mini_mcmc_tpu import MetropolisHastings as JaxMH
from mini_mcmc_tpu import ParallelTempering as JaxPT
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.checkpoint import restore_sampler as jax_restore
from mini_mcmc_tpu.checkpoint import save_sampler as jax_save
from mini_mcmc_tpu.models.precondition import Preconditioner as JaxPre
from mini_mcmc_tpu.models.transforms import Bijector as JaxBijector
from mini_mcmc_tpu.models.transforms import CoordinateTransform as JaxCT
from mini_mcmc_tpu.ops.sgmcmc import target_grad as jax_target_grad

torch.set_num_threads(1)

CPU = dict(device="cpu")
COV = [[4.0, 2.0], [2.0, 3.0]]
LW_MINUS, LW_PLUS = float(np.log(0.3)), float(np.log(0.7))


def _path(tmp_path, name="ckpt"):
    return str(tmp_path / name)


def _init(c, d, seed=0, scale=1.0, shift=0.0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((c, d)) * scale + shift).astype(np.float32)


def _t(a):
    return torch.as_tensor(a)


def _states_equal(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        else:
            assert x == y


def _resume(make, tmp_path, first=(16, 0), cont=(16, 0)):
    """``make(seed)``'s sampler runs ``first``, is saved, runs ``cont``; a
    sampler from another seed restored from the checkpoint runs ``cont``:
    returns both continuations and both samplers."""
    a = make(9)
    a.run(*first)
    save_sampler(_path(tmp_path), a)
    cont_a = a.run(*cont)
    b = make(4321)
    assert b is restore_sampler(_path(tmp_path), b)
    cont_b = b.run(*cont)
    return cont_a, cont_b, a, b


# -- the cases of tests/test_checkpoint.py -----------------------------------


def _mh(seed, n_chains=3, **kw):
    return mt.MetropolisHastings(
        mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        mt.isotropic_gaussian_proposal(1.0), _t(_init(n_chains, 2)), **CPU,
        **kw).seed(seed)


def test_mh_checkpoint_resume_bitexact(tmp_path):
    cont_a, cont_b, _, _ = _resume(_mh, tmp_path, (40, 0), (60, 0))
    assert torch.equal(cont_a, cont_b)


def test_hmc_checkpoint_resume_bitexact(tmp_path):
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.HMC(mt.rosenbrock_nd(), _t(_init(2, 3, 1, 0.3, 1.0)),
                         0.03, 5, **CPU).seed(s), tmp_path, (20, 0), (20, 0))
    assert torch.equal(cont_a, cont_b)


def test_gibbs_checkpoint_resume_bitexact(tmp_path):
    cond = mt.gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5)
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.GibbsSampler(cond, torch.zeros((3, 2)), **CPU).seed(s),
        tmp_path, (40, 0), (60, 0))
    assert torch.equal(cont_a, cont_b)


@pytest.mark.parametrize("backend", ["orbax", "npz"])
def test_checkpoint_jax_backends_raise(tmp_path, backend):
    # the JAX package's formats: orbax and its npz fallback exist there
    # because of orbax; the port writes one torch.save file
    with pytest.raises(ValueError, match="JAX package"):
        save_sampler(_path(tmp_path), _mh(9), backend=backend)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        save_sampler(_path(tmp_path), _mh(9), backend="zarr")
    assert os.listdir(tmp_path) == []


def test_checkpoint_default_writes_one_pt_file(tmp_path):
    a = _mh(9)
    a.run(20, 0)
    save_sampler(_path(tmp_path), a)
    save_sampler(_path(tmp_path, "t"), a, backend="torch")
    assert sorted(os.listdir(tmp_path)) == ["ckpt.pt", "t.pt"]
    payload = torch.load(_path(tmp_path) + ".pt", weights_only=True)
    assert payload["type"] == "MHState" and payload["version"] == 1
    assert set(payload["fields"]) == {"positions", "logp"}


def test_checkpoint_resave_loads_the_newer_state(tmp_path):
    # a later save at the same path replaces the earlier one
    a = _mh(9)
    save_sampler(_path(tmp_path), a)
    a.run(20, 0)
    save_sampler(_path(tmp_path), a)
    cont_a = a.run(20, 0)
    b = restore_sampler(_path(tmp_path), _mh(0))
    assert torch.equal(cont_a, b.run(20, 0))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


def test_checkpoint_saved_on_cpu_loads_with_device_cpu(tmp_path):
    a = mt.HMC(mt.rosenbrock_nd(), _t(_init(16, 3, 2, 0.3, 1.0)), 0.03, 5,
               **CPU).seed(2)
    a.run(20, 0)
    save_sampler(_path(tmp_path), a)
    state, gen = load_checkpoint(_path(tmp_path), device="cpu")
    _states_equal(state, a.state)
    assert state.positions.device.type == "cpu"
    assert torch.equal(gen.get_state(), a._gen.get_state())
    # the default device is the card, which this machine lacks
    if torch.cuda.is_available():
        assert load_checkpoint(_path(tmp_path))[0].positions.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(_path(tmp_path))
    # a sampler built on the loaded state continues as the saved one
    cont_a = a.run(20, 0)
    b = mt.HMC(mt.rosenbrock_nd(), torch.zeros((16, 3)), 0.03, 5, **CPU)
    b.state, b._gen = state, gen
    assert torch.equal(cont_a, b.run(20, 0))


def _nuts(seed, n_chains=2, **kw):
    return mt.NUTS(mt.diffable_gaussian2d([0.0, 1.0], COV),
                   _t(_init(n_chains, 2, 3)), 0.8, **CPU, **kw).seed(seed)


def test_nuts_checkpoint_preserves_adaptation(tmp_path):
    cont_a, cont_b, a, b = _resume(_nuts, tmp_path, (10, 10), (15, 0))
    assert torch.equal(cont_a, cont_b)
    _states_equal(a.state, b.state)
    assert a.state.m == b.state.m == 10 + 10 - 1 + 15 - 1
    assert torch.equal(a.last_run_divergences, b.last_run_divergences)


def test_metric_sampler_checkpoint_roundtrip_and_mismatch_guard(tmp_path):
    target = mt.diffable_gaussian2d([0.0, 1.0], COV)
    init = _t(_init(4, 2, 5))
    pre = mt.Preconditioner("dense", chol=torch.linalg.cholesky(
        torch.tensor(COV)))
    a = mt.HMC(target, init, 0.9, 8, metric=pre, **CPU).seed(5)
    a.run(10, 10)
    save_sampler(_path(tmp_path), a)
    cont_a = a.run(15, 0)
    b = mt.HMC(target, init, 0.9, 8, metric=pre, **CPU).seed(6)
    restore_sampler(_path(tmp_path), b)
    assert torch.equal(cont_a, b.run(15, 0))

    plain = mt.HMC(target, init, 0.9, 8, **CPU).seed(7)
    with pytest.raises(ValueError, match="metric"):
        restore_sampler(_path(tmp_path), plain)
    other = mt.HMC(target, init, 0.9, 8, metric=mt.Preconditioner(
        "diag", scale=torch.tensor([2.0, 1.7])), **CPU).seed(8)
    with pytest.raises(ValueError, match="metric"):
        restore_sampler(_path(tmp_path), other)
    save_sampler(_path(tmp_path, "plain"), plain)
    with pytest.raises(ValueError, match="metric"):
        restore_sampler(_path(tmp_path, "plain"), a)


def test_unknown_format_version_and_jax_checkpoints_raise(tmp_path):
    # no port checkpoint predates the format: another version raises (the
    # JAX package's `leapfrogs` migration has no counterpart)
    s = _nuts(1, 4)
    s.run(5, 2)
    save_sampler(_path(tmp_path), s)
    payload = torch.load(_path(tmp_path) + ".pt", weights_only=True)
    payload["version"] = 2
    torch.save(payload, _path(tmp_path) + ".pt")
    with pytest.raises(ValueError, match="format version 2"):
        restore_sampler(_path(tmp_path), _nuts(9, 4))
    # a JAX checkpoint (orbax or npz beside a pickled treedef) is refused
    # before anything is unpickled
    jax_mh = JaxMH(jm.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                   jm.isotropic_gaussian_proposal(1.0),
                   jnp.asarray(_init(4, 2))).seed(1)
    jax_save(_path(tmp_path, "jax"), jax_mh, backend="npz")
    with pytest.raises(ValueError, match="JAX package"):
        restore_sampler(_path(tmp_path, "jax"), _mh(1, 4))


def test_state_type_mismatch_raises(tmp_path):
    save_sampler(_path(tmp_path), _nuts(1))
    hmc = mt.HMC(mt.diffable_gaussian2d([0.0, 1.0], COV),
                 _t(_init(2, 2, 3)), 0.5, 4, **CPU)
    with pytest.raises(ValueError, match="NUTSState.*HMCState"):
        restore_sampler(_path(tmp_path), hmc)


def test_tracker_state_roundtrip(tmp_path):
    tracker = mt.stats.tracker_init(4, 2, **CPU)
    gen = torch.Generator().manual_seed(0)
    for x in torch.randn((5, 4, 2), generator=gen):
        tracker = mt.stats.tracker_update(tracker, x)
    save_checkpoint(_path(tmp_path), tracker)
    state, gen = load_checkpoint(_path(tmp_path), device="cpu")
    _states_equal(state, tracker)
    assert gen is None and state.n == 5


# -- the resume cases of the other JAX test files ----------------------------


def test_chees_checkpoint_roundtrip_continues_bitwise(tmp_path):
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.ChEESHMC(mt.standard_normal(), _t(_init(8, 2)),
                              step_size=0.5, traj_len=1.5, seed=s, **CPU),
        tmp_path, (20, 0), (30, 0))
    assert torch.equal(cont_a, cont_b)


def test_ensemble_checkpoint_resume_bitexact(tmp_path):
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.5], [0.5, 2.0]])
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.EnsembleSampler(target, _t(_init(8, 2)), **CPU).seed(s),
        tmp_path, (40, 0), (60, 0))
    assert torch.equal(cont_a, cont_b)


def test_slice_checkpoint_resume_bitexact(tmp_path):
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.5], [0.5, 2.0]])
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.SliceSampler(target, _t(_init(8, 2)), **CPU).seed(s),
        tmp_path, (30, 0), (40, 0))
    assert torch.equal(cont_a, cont_b)


def _gauss_lik(mean, std):
    mean = torch.tensor(mean)
    return Target(logp=lambda x: -0.5 * torch.sum(((x - mean) / std) ** 2,
                                                  dim=-1))


def test_elliptical_checkpoint_resume_bitexact(tmp_path):
    cont_a, cont_b, _, _ = _resume(
        lambda s: mt.EllipticalSliceSampler(
            _gauss_lik([1.0, 0.0], 1.0), _t(_init(8, 2)), **CPU).seed(s),
        tmp_path, (30, 0), (40, 0))
    assert torch.equal(cont_a, cont_b)


def _mixture() -> Target:
    """0.3 N(-8, 0.5^2) + 0.7 N(8, 0.5^2), naming the CUDA functor."""

    def logp(x):
        a = LW_MINUS - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = LW_PLUS - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                  cuda_params=(LW_MINUS, -8.0, 0.5, LW_PLUS, 8.0, 0.5))


def test_tempering_checkpoint_resume_bitexact(tmp_path):
    betas = mt.geometric_betas(4, 0.05)
    cont_a, cont_b, a, b = _resume(
        lambda s: mt.ParallelTempering(_mixture(), torch.full((4, 1), -8.0),
                                       betas=betas, **CPU).seed(s),
        tmp_path, (40, 0), (60, 0))
    assert torch.equal(cont_a, cont_b)
    _states_equal(a.state, b.state)  # the hot rungs and the parity too


def test_sgld_checkpoint_roundtrip(tmp_path):
    grad_fn = mt.target_grad(mt.standard_normal())
    cont_a, cont_b, _, b = _resume(
        lambda s: mt.SGLD(grad_fn, _t(_init(4, 2)), step_size=0.05, seed=s,
                          **CPU), tmp_path, (16, 0), (16, 0))
    assert torch.equal(cont_a, cont_b)
    assert b.state.step == 32


def _scale_location_target():
    """x0 > 0 scale, x1 unconstrained: logp = -x0 - (x1/x0)^2/2 - log x0."""
    return Target(logp=lambda x: (-x[..., 0] - 0.5 * (x[..., 1] / x[..., 0])
                                  ** 2 - torch.log(x[..., 0])))


def _natural_init(n):
    x = _init(n, 2, 6)
    x[:, 0] = np.exp(0.3 * x[:, 0])  # the scale coordinate > 0
    # x1 > 0 too, so that the guard case's transform of x1 builds
    x[:, 1] = np.abs(x[:, 1]) + 0.1
    return _t(x)


def test_transform_checkpoint_guard(tmp_path):
    natural = _scale_location_target()
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    s = mt.HMC(natural, _natural_init(8), 0.05, 3, transform=tf,
               **CPU).seed(1)
    s.run(5, 0)
    save_sampler(_path(tmp_path), s)
    r = mt.HMC(natural, _natural_init(8), 0.05, 3, transform=tf,
               **CPU).seed(99)
    restore_sampler(_path(tmp_path), r)
    assert torch.equal(s.run(5, 0), r.run(5, 0))

    other = mt.CoordinateTransform({1: mt.positive()}, dim=2)
    bad = mt.HMC(natural, _natural_init(8), 0.05, 3, transform=other, **CPU)
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(_path(tmp_path), bad)
    plain = mt.HMC(natural, _natural_init(8), 0.05, 3, **CPU)
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(_path(tmp_path), plain)


def _mk_exp():  # the default name "bijector"
    return Bijector(torch.exp, torch.log, lambda y: y)


def _mk_softplus():  # also "bijector", another map
    return Bijector(lambda y: torch.logaddexp(y, torch.zeros_like(y)),
                    lambda x: x + torch.log(-torch.expm1(-x)),
                    lambda y: -torch.log1p(torch.exp(-y)))


def test_checkpoint_probe_distinguishes_same_named_custom_bijectors(
        tmp_path):
    target = mt.gaussian2d([1.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    prop = mt.isotropic_gaussian_proposal(0.4)
    x0 = _t(np.abs(_init(8, 2)) + 0.5)

    def mk(bij, seed):
        return mt.MetropolisHastings(
            target, prop, x0, transform=mt.CoordinateTransform(
                {0: bij}, dim=2), **CPU).seed(seed)

    s = mk(_mk_exp(), 1)
    s.run(3, 0)
    save_sampler(_path(tmp_path), s)
    restore_sampler(_path(tmp_path), mk(_mk_exp(), 9))  # a fresh instance
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(_path(tmp_path), mk(_mk_softplus(), 9))


# -- every sampler, every tier -----------------------------------------------


def _samplers():
    init2 = lambda c, s: _t(_init(c, 2, s))  # noqa: E731
    rosen = lambda: _t(_init(16, 3, 1, 0.3, 1.0))  # noqa: E731
    dense = mt.Preconditioner("dense", chol=torch.linalg.cholesky(
        torch.tensor([[2.0, 0.3], [0.3, 0.5]])))
    gauss = mt.diffable_gaussian2d([0.0, 1.0], COV)
    positive = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    grad_fn = mt.target_grad(mt.standard_normal())
    return {
        "hmc": lambda s: mt.HMC(mt.rosenbrock_nd(), rosen(), 0.02, 8,
                                jitter=0.3, **CPU).seed(s),
        "hmc_true": lambda s: mt.HMC(mt.rosenbrock_nd(), rosen(), 0.02, 8,
                                     use_pallas=True, steps_per_call=4,
                                     **CPU).seed(s),
        "hmc_full": lambda s: mt.HMC(mt.rosenbrock_nd(), rosen(), 0.02, 8,
                                     use_pallas="full", jitter=0.3,
                                     steps_per_call=4, **CPU).seed(s),
        "hmc_full_metric": lambda s: mt.HMC(
            gauss, init2(16, 2), 0.3, 4, use_pallas="full",
            steps_per_call=4, metric=dense, **CPU).seed(s),
        "hmc_full_transform": lambda s: mt.HMC(
            gauss, init2(16, 2).abs() + 0.1, 0.2, 4, use_pallas="full",
            steps_per_call=4, transform=positive, **CPU).seed(s),
        "separable": lambda s: mt.HMC(
            mt.standard_normal(), _t(_init(8, 64, 4)), 0.1, 5,
            use_pallas="separable", **CPU).seed(s),
        "mala_full": lambda s: mt.MALA(gauss, init2(16, 3), 0.8,
                                       use_pallas="full", steps_per_call=4,
                                       **CPU).seed(s),
        "nuts": lambda s: _nuts(s, 8),
        "nuts_true": lambda s: _nuts(s, 8, use_pallas=True),
        "nuts_full": lambda s: _nuts(s, 8, use_pallas="full"),
        "nuts_full_metric": lambda s: _nuts(s, 8, use_pallas="full",
                                            metric=dense),
        "mh": lambda s: _mh(s, 16),
        "mh_full": lambda s: _mh(s, 16, use_pallas="full", steps_per_call=4),
        "mh_full_transform": lambda s: mt.MetropolisHastings(
            mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
            mt.isotropic_gaussian_proposal(0.8), init2(16, 4).abs() + 0.1,
            use_pallas="full", steps_per_call=4, transform=positive,
            **CPU).seed(s),
        "poisson_full": lambda s: mt.MetropolisHastings(
            mt.poisson_target(4.0), mt.random_walk_int_proposal(),
            torch.full((16, 1), 3, dtype=torch.int32), use_pallas="full",
            steps_per_call=4, **CPU).seed(s),
        "gibbs_full": lambda s: mt.GibbsSampler(
            mt.gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
            torch.zeros((16, 2)), use_pallas="full", steps_per_call=4,
            **CPU).seed(s),
        "pt": lambda s: mt.ParallelTempering(
            _mixture(), torch.full((16, 1), -8.0), betas=(1.0, 0.3, 0.1),
            **CPU).seed(s),
        "pt_full": lambda s: mt.ParallelTempering(
            _mixture(), torch.full((16, 1), -8.0), betas=(1.0, 0.3, 0.1),
            steps_per_call=4, use_pallas="full", **CPU).seed(s),
        "chees": lambda s: mt.ChEESHMC(gauss, init2(16, 5), 0.5,
                                       traj_len=1.5, **CPU).seed(s),
        "ensemble": lambda s: mt.EnsembleSampler(gauss, init2(16, 6),
                                                 steps_per_call=4,
                                                 **CPU).seed(s),
        "slice": lambda s: mt.SliceSampler(gauss, init2(16, 7),
                                           width="auto", **CPU).seed(s),
        "elliptical": lambda s: mt.EllipticalSliceSampler(
            _gauss_lik([1.0, 0.0], 1.0), init2(16, 8), **CPU).seed(s),
        "sgld": lambda s: mt.SGLD(grad_fn, init2(16, 9), 0.05,
                                  steps_per_call=4, **CPU).seed(s),
        "psgld": lambda s: mt.SGLD(grad_fn, init2(16, 10),
                                   mt.polynomial_decay(0.05, 10.0, 0.33),
                                   preconditioner="rmsprop", **CPU).seed(s),
        "sghmc": lambda s: mt.SGHMC(grad_fn, init2(16, 11), 0.05,
                                    friction=0.3, **CPU).seed(s),
    }


@pytest.mark.parametrize("name", list(_samplers()))
def test_every_sampler_resumes_bit_for_bit(name, tmp_path):
    make = _samplers()[name]
    first = (8, 8) if name.startswith("nuts") else (8, 0)
    cont_a, cont_b, a, b = _resume(make, tmp_path, first, (8, 0))
    assert torch.equal(cont_a, cont_b)
    _states_equal(a.state, b.state)
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    # and again after the continuation: nothing outside state and the
    # generator carries over between runs
    assert torch.equal(a.run(8, 0), b.run(8, 0))


def test_restore_casts_to_the_samplers_dtype(tmp_path):
    # a float32 state restores into a float64 sampler: each field takes the
    # restoring sampler's dtype (and device), as the JAX package casts
    a = _mh(2, 4)
    a.run(4, 0)
    save_sampler(_path(tmp_path), a)
    b = mt.MetropolisHastings(
        mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        mt.isotropic_gaussian_proposal(1.0), torch.zeros((4, 2),
                                                         dtype=torch.float64),
        **CPU)
    restore_sampler(_path(tmp_path), b)
    assert b.state.positions.dtype == torch.float64
    assert torch.equal(b.state.positions, a.state.positions.double())


# -- guard parity with the JAX package ---------------------------------------


def _jax_hmc(init, metric=None):
    return JaxHMC(jm.diffable_gaussian2d([0.0, 1.0], COV), jnp.asarray(init),
                  0.5, 4, metric=metric).seed(1)


def _port_hmc(init, metric=None):
    return mt.HMC(mt.diffable_gaussian2d([0.0, 1.0], COV), _t(init), 0.5, 4,
                  metric=metric, **CPU).seed(1)


def _metrics(kind):
    """(JAX metric, port metric) of a named case."""
    chol = np.linalg.cholesky(np.asarray(COV, np.float32)).astype(np.float32)
    scale = np.asarray([2.0, 1.7], np.float32)
    if kind == "dense":
        return (JaxPre(kind="dense", chol=jnp.asarray(chol)),
                mt.Preconditioner("dense", chol=_t(chol)))
    if kind == "diag":
        return (JaxPre(kind="diag", scale=jnp.asarray(scale)),
                mt.Preconditioner("diag", scale=_t(scale)))
    if kind == "diag_other":
        other = np.asarray([2.0, 1.5], np.float32)
        return (JaxPre(kind="diag", scale=jnp.asarray(other)),
                mt.Preconditioner("diag", scale=_t(other)))
    return None, None


def _jax_mh(x0, bijectors):
    tf = None if bijectors is None else JaxCT(bijectors, dim=2)
    return JaxMH(jm.gaussian2d([1.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                 jm.isotropic_gaussian_proposal(0.4), jnp.asarray(x0),
                 transform=tf).seed(1)


def _port_mh(x0, bijectors):
    tf = None if bijectors is None else mt.CoordinateTransform(bijectors,
                                                                dim=2)
    return mt.MetropolisHastings(
        mt.gaussian2d([1.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        mt.isotropic_gaussian_proposal(0.4), _t(x0), transform=tf,
        **CPU).seed(1)


def _jax_bijectors(name):
    return {
        None: None,
        "positive0": {0: jm.positive()},
        "positive1": {1: jm.positive()},
        "exp": {0: JaxBijector(jnp.exp, jnp.log, lambda y: y)},
        "softplus": {0: JaxBijector(
            lambda y: jnp.logaddexp(y, 0.0),
            lambda x: x + jnp.log(-jnp.expm1(-x)),
            lambda y: -jnp.log1p(jnp.exp(-y)))},
    }[name]


def _port_bijectors(name):
    return {None: None, "positive0": {0: mt.positive()},
            "positive1": {1: mt.positive()}, "exp": {0: _mk_exp()},
            "softplus": {0: _mk_softplus()}}[name]


#: (case, saved, restoring, whether the restore must raise and the word)
GUARD_CASES = [
    ("metric_kind", ("hmc", "dense"), ("hmc", "diag"), "metric"),
    ("metric_array", ("hmc", "diag"), ("hmc", "diag_other"), "metric"),
    ("metric_against_none", ("hmc", "dense"), ("hmc", None), "metric"),
    ("none_against_metric", ("hmc", None), ("hmc", "diag"), "metric"),
    ("same_metric", ("hmc", "dense"), ("hmc", "dense"), None),
    ("transform_name", ("mh", "positive0"), ("mh", "positive1"),
     "transform"),
    ("transform_against_none", ("mh", "positive0"), ("mh", None),
     "transform"),
    ("none_against_transform", ("mh", None), ("mh", "positive0"),
     "transform"),
    ("same_named_custom", ("mh", "exp"), ("mh", "softplus"), "transform"),
    ("same_custom_map", ("mh", "exp"), ("mh", "exp"), None),
    ("chain_count", ("hmc4", None), ("hmc", None), "shape"),
]


def _build(spec, jax: bool):
    kind, arg = spec
    if kind.startswith("hmc"):
        init = _init(4 if kind == "hmc4" else 6, 2, 12)
        metric = _metrics(arg)[0 if jax else 1]
        return (_jax_hmc if jax else _port_hmc)(init, metric)
    x0 = np.abs(_init(6, 2, 13)) + 0.5
    if jax:
        return _jax_mh(x0, _jax_bijectors(arg))
    return _port_mh(x0, _port_bijectors(arg))


@pytest.mark.parametrize("case, saved, restoring, word", GUARD_CASES,
                         ids=[c[0] for c in GUARD_CASES])
def test_guards_raise_where_the_jax_packages_do(tmp_path, case, saved,
                                                restoring, word):
    outcomes = []
    for jax, save, restore in ((True, jax_save, jax_restore),
                               (False, save_sampler, restore_sampler)):
        path = _path(tmp_path, "jax" if jax else "port")
        kw = dict(backend="npz") if jax else {}
        save(path, _build(saved, jax), **kw)
        try:
            restore(path, _build(restoring, jax))
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    jax_msg, port_msg = outcomes
    if word is None:
        assert jax_msg is None and port_msg is None
    else:
        assert jax_msg is not None and port_msg is not None
        assert word in jax_msg and word in port_msg


# -- JAX states through convert, saved and loaded by the port -----------------


@functools.cache
def _jax_states():
    x2 = jnp.asarray(_init(8, 2, 14))
    nuts = JaxNUTS(jm.diffable_gaussian2d([0.0, 1.0], COV), x2, 0.8).seed(2)
    nuts.run(4, 4)
    hmc = JaxHMC(jm.rosenbrock_nd(), jnp.asarray(_init(8, 3, 15, 0.3, 1.0)),
                 0.02, 4).seed(3)
    hmc.run(4, 0)
    mh = JaxMH(jm.poisson_target(4.0), jm.random_walk_int_proposal(),
               jnp.full((8, 1), 3, jnp.int32)).seed(4)
    mh.run(4, 0)
    pt = JaxPT(jm.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]), x2,
               betas=(1.0, 0.5, 0.25)).seed(5)
    pt.run(5, 0)
    sgld = JaxSGLD(jax_target_grad(jm.standard_normal()), x2, 0.05,
                   preconditioner="rmsprop", seed=6)
    sgld.run(4, 0)
    return {
        "hmc": (hmc.state, lambda s: convert.hmc_state_from_numpy(
            s.positions, s.logp, s.grad, **CPU)),
        "nuts": (nuts.state, lambda s: convert.nuts_state_from_numpy(
            s, **CPU)),
        "mh_int32": (mh.state, lambda s: convert.mh_state_from_numpy(
            s.positions, s.logp, **CPU)),
        "pt": (pt.state, lambda s: convert.pt_state_from_numpy(s, **CPU)),
        "sgld": (sgld.state, lambda s: convert.sgld_state_from_numpy(
            s.positions, s.sq_avg, s.step, **CPU)),
    }


@pytest.mark.parametrize("name", ["hmc", "nuts", "mh_int32", "pt", "sgld"])
def test_jax_state_through_convert_roundtrips_exactly(name, tmp_path):
    jax_state, to_port = _jax_states()[name]
    state = to_port(jax_state)
    save_checkpoint(_path(tmp_path), state)
    loaded, gen = load_checkpoint(_path(tmp_path), device="cpu")
    assert gen is None
    _states_equal(loaded, state)
    for field in type(state)._fields:
        got, want = getattr(loaded, field), getattr(jax_state, field)
        if torch.is_tensor(got):
            want = np.asarray(want)
            assert got.dtype == torch.from_numpy(
                want.astype(got.numpy().dtype)).dtype
            np.testing.assert_array_equal(got.numpy(), want)
        else:  # NUTS's m is one count a chain in the JAX package
            assert np.all(np.asarray(want) == got)


# -- the two ADVICE.md faults of the JAX module, not copied ----------------


def test_probe_keeps_five_significant_digits():
    # the JAX module formats with precision=5, six significant digits; its
    # docstring promises five
    text = ck._probe_text(mt.positive())
    name, values = text.split("|")
    assert name == "positive"
    values = values.split(",")
    assert len(values) == 2 * len(ck.PROBE_POINTS)
    for v in values:
        assert re.fullmatch(r"-?\d\.\d{4}e[+-]\d\d", v), v
    # a change in the sixth significant digit does not move the crc; one
    # in the fourth does
    def scaled(f):
        # only forward moves (the probe reads log_det at face value)
        return Bijector(lambda y: torch.exp(y) * f, torch.log, lambda y: y)

    crc = ck._bijector_probe_crc
    assert crc(scaled(1.0)) == crc(scaled(1.0 + 2e-7))
    assert crc(scaled(1.0)) != crc(scaled(1.003))


def test_probe_cache_holds_bijectors_weakly():
    # the JAX module caches in a default dict argument, which pins every
    # probed bijector (and its closures) for the process's life
    bij = _mk_softplus()
    crc = ck._bijector_probe_crc(bij)
    assert ck._bijector_probe_crc(bij) == crc
    assert bij in ck._PROBE_CRC
    ref = weakref.ref(bij)
    del bij
    gc.collect()
    assert ref() is None
    assert all(b is not None for b in ck._PROBE_CRC.keys())
