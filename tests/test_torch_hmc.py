"""The port's slice end to end: ``mini_mcmc_torch.HMC`` against
``mini_mcmc_tpu.HMC`` built from one kwargs dict and one start state.

The samplers draw from different generators (threefry against PyTorch's
and Philox), so they are held to the same quality gates as bench.py:183-187
on a reduced flagship: Rosenbrock3D, 256 chains, L=64, eps=0.03 with 30%
jitter, K=16, 256 burn-in and 512 recorded draws (cut from 65,536 chains x
8,192 draws at L=192 to fit the CPU tests; the longer step and shorter
trajectory keep the per-chain mixing the gates need). Deterministic
properties (layouts, seeding, block-size independence, continuation) are
checked exactly.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    hmc_state_from_numpy,
    sampler_kwargs,
    state_to_numpy,
)
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm

torch.set_num_threads(1)

C, N_BURN, N_DRAW = 256, 256, 512
KW = dict(step_size=0.03, n_leapfrog=64, jitter=0.3, steps_per_call=16)
X0_MEAN, X0_VAR = 0.785217, 0.229370  # bench.py:91-92


def _init(c=C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, 3)) * 0.5 + 1.0).astype(np.float32)


def _gates(sample_tm, rhat, ess):
    """bench.py:183-187 on a time-major cube (numpy arrays)."""
    n, c, _ = sample_tm.shape
    x0 = sample_tm[:, :, 0].astype(np.float64)
    assert 0.95 <= rhat.mean() <= 1.05, rhat
    assert ess.min() >= 0.01 * n * c, ess
    assert abs(x0.mean() - X0_MEAN) <= 0.05, x0.mean()
    assert abs(x0.var() - X0_VAR) <= 0.04, x0.var()


def _jax_sampler(use_pallas, **kw):
    return jmt.HMC(jm.rosenbrock_nd(), jnp.asarray(_init(), jnp.float32),
                   use_pallas=use_pallas, **{**KW, **kw})


def test_start_state_carries_over_through_convert():
    j = _jax_sampler(False)
    kwargs = sampler_kwargs(j)
    assert kwargs == dict(use_pallas=False, validate_dc=True, **KW)
    port = mt.HMC(mt.rosenbrock_nd(), _init(), **kwargs, device="cpu")
    carried = hmc_state_from_numpy(*(np.asarray(x) for x in j.state),
                                   device="cpu")
    for a, b in zip(state_to_numpy(port.state), state_to_numpy(carried)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    port.state = carried
    assert port.run(16, 0).shape == (C, 16, 3)


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_port_reduced_flagship_passes_bench_gates(use_pallas):
    j = _jax_sampler(use_pallas)
    port = mt.HMC(mt.rosenbrock_nd(), _init(),
                  **{**sampler_kwargs(j), "use_pallas": use_pallas},
                  device="cpu").seed(42)
    port.state = hmc_state_from_numpy(*(np.asarray(x) for x in j.state),
                                      device="cpu")
    port.run(N_BURN, 0, time_major=True)
    sample = port.run(N_DRAW, 0, time_major=True)
    assert sample.shape == (N_DRAW, C, 3) and sample.dtype == torch.float32
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    _gates(sample.numpy(), rhat.numpy(), ess.numpy())


def test_jax_reduced_flagship_passes_bench_gates():
    j = _jax_sampler(False).seed(42)
    j.run(N_BURN, 0, time_major=True)
    sample = j.run(N_DRAW, 0, time_major=True)
    rhat, ess = jmt.split_rhat_mean_ess(sample, time_major=True)
    _gates(np.asarray(sample), np.asarray(rhat), np.asarray(ess))


def test_trajectory_tier_follows_the_plain_tier():
    """use_pallas=True changes only who integrates the trajectory: on CPU
    tensors the port's True tier is bit-identical to its plain tier, and
    the JAX package's interpreted Pallas tier follows its XLA tier."""
    kw = dict(KW, n_leapfrog=8)
    init = _init(16, seed=1)
    a = mt.HMC(mt.rosenbrock_nd(), init, use_pallas=False, **kw,
               device="cpu").seed(3)
    b = mt.HMC(mt.rosenbrock_nd(), init, use_pallas=True, **kw,
               device="cpu").seed(3)
    assert torch.equal(a.run(32, 16), b.run(32, 16))
    ja = jmt.HMC(jm.rosenbrock_nd(), jnp.asarray(init), use_pallas=False,
                 **kw).seed(3)
    jb = jmt.HMC(jm.rosenbrock_nd(), jnp.asarray(init), use_pallas=True,
                 pallas_interpret=True, **kw).seed(3)
    np.testing.assert_allclose(np.asarray(jb.run(32, 16)),
                               np.asarray(ja.run(32, 16)),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_layouts_seeding_and_continuation(use_pallas):
    kw = dict(KW, n_leapfrog=4)
    init = torch.from_numpy(_init(32, seed=2))

    def make(seed=5):
        return mt.HMC(mt.rosenbrock_nd(), init, use_pallas=use_pallas,
                      **kw, device="cpu").seed(seed)

    cm = make().run(32, 16)
    assert cm.shape == (32, 32, 3)
    tm = make().run(32, 16, time_major=True)
    assert tm.shape == (32, 32, 3)
    assert torch.equal(tm.transpose(0, 1), cm)  # one stream, two layouts
    assert torch.equal(make().run(32, 16), cm)  # same seed, same cube
    assert not torch.equal(make(6).run(32, 16), cm)
    assert torch.isfinite(cm).all()

    s = make()
    first = s.run(16, 0)
    assert torch.equal(s.positions, first[:, -1])  # last recorded row
    second = s.run(16, 0)
    assert not torch.equal(second[:, 0], first[:, 0])  # chains continued
    # the initial positions were copied, never aliased
    assert torch.equal(init, torch.from_numpy(_init(32, seed=2)))


def test_full_tier_stream_does_not_depend_on_block_size():
    kw = dict(KW, n_leapfrog=4, jitter=0.0)
    init = _init(16, seed=3)
    cubes = [mt.HMC(mt.rosenbrock_nd(), init, use_pallas="full",
                    **{**kw, "steps_per_call": k},
                    device="cpu").seed(9).run(16, 16)
             for k in (1, 4, 16)]
    assert torch.equal(cubes[0], cubes[1])
    assert torch.equal(cubes[0], cubes[2])


def test_run_lengths_must_be_block_multiples():
    s = mt.HMC(mt.rosenbrock_nd(), _init(8), use_pallas="full", **KW,
               device="cpu")
    with pytest.raises(ValueError, match="multiples of the block size 16"):
        s.run(24, 0)
    with pytest.raises(ValueError, match="multiples"):
        s.run(16, 8)


def test_constructor_validation():
    # the separable tier is ported; Rosenbrock couples its coordinates
    with pytest.raises(ValueError, match="separable"):
        mt.HMC(mt.rosenbrock_nd(), _init(8), 0.02, 4, use_pallas="separable",
               device="cpu")
    with pytest.raises(ValueError, match="use_pallas"):
        mt.HMC(mt.rosenbrock_nd(), _init(8), 0.02, 4, use_pallas="fused",
               device="cpu")
    with pytest.raises(ValueError, match="steps_per_call"):
        mt.HMC(mt.rosenbrock_nd(), _init(8), 0.02, 4, steps_per_call=0,
               device="cpu")
    with pytest.raises(ValueError, match=r"\[n_chains, dim\]"):
        mt.HMC(mt.rosenbrock_nd(), np.zeros(3, np.float32), 0.02, 4,
               device="cpu")
    # a target without a CUDA functor runs every tier on CPU tensors
    plain = mt.models.Target(logp=mt.rosenbrock_nd().logp)
    sample = mt.HMC(plain, _init(8), 0.02, 4, use_pallas="full",
                    device="cpu").run(4)
    assert sample.shape == (8, 4, 3)


def test_sampler_kwargs_rejects_what_is_not_ported():
    ctor = dict(KW, use_pallas=False, unroll=8, pallas_interpret=False,
                validate_dc=True, transform=None)
    assert sampler_kwargs(SimpleNamespace(_ctor=ctor, metric=None)) == dict(
        KW, use_pallas=False, validate_dc=True)
    with pytest.raises(ValueError, match="transform"):
        sampler_kwargs(SimpleNamespace(_ctor=dict(ctor, transform=object()),
                                       metric=None))
    with pytest.raises(ValueError, match="metric must be a Preconditioner"):
        sampler_kwargs(SimpleNamespace(_ctor=ctor, metric=object()))
