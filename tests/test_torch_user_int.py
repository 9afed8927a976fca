"""Int32 user forms in the MH kernel (Kernel 5): a discrete density as a
hand ``cuda_source`` (examples/user_forms.py:POISSON_SOURCE, a copy of
``targets.cuh:Poisson``) or generated from its batch form on int32 states
(``models.discrete.binomial_target``), and an int32 user proposal
(examples/user_forms.py:INT_WALK_SOURCE, ``proposals.cuh:RandomWalkInt``
as a source), built for the host with ``g++`` through
``csrc/host_shim.h`` (the text nvcc compiles), against the JAX package's
``dc_forms()`` on the same int32 states and the port's twins.

Tolerances: a density's value within 1e-5 of max(|want|, 1) against the
JAX chains-on-lanes form, whose Poisson log-factorial is a Lanczos series
(``mini_mcmc_tpu/utils/mathx.py``, ~1e-5 relative from ``lax.lgamma``);
both ``-inf`` off the support. A proposal's int32 states exactly. The
samplers' pmf within 0.05 of the truth, as tests/test_mh.py:73-90.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import Proposal, Target
from mini_mcmc_torch.models.base import (
    validate_dc_forms,
    validate_proposal_dc,
)
from mini_mcmc_torch.models.discrete import (
    binomial_target,
    poisson_target,
    random_walk_int_proposal,
)
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_torch.ops.kernels.mh_full import mh_instance
from mini_mcmc_tpu import models as jm

torch.set_num_threads(1)

CPU = dict(device="cpu")
I32 = torch.int32
N, P, LAM = 10, 0.3, 4.0


def _forms():
    """name -> (port target, JAX target): the hand Poisson source and the
    traced binomial, with the traced Poisson beside them."""
    return {
        "poisson_hand": (F.poisson_user(LAM), jm.poisson_target(LAM)),
        "poisson_traced": (Target(logp=poisson_target(LAM).logp),
                           jm.poisson_target(LAM)),
        "binomial_traced": (binomial_target(N, P), jm.binomial_target(N, P)),
    }


def _states():
    """Int32 states on and off both supports: -2**20, -3..N + 4."""
    return torch.tensor([-(1 << 20)] + list(range(-3, N + 5)),
                        dtype=I32)[:, None]


@pytest.mark.parametrize("name", list(_forms()))
def test_int32_density_matches_jax_dc_forms(name):
    t, jt = _forms()[name]
    k = _states()
    got, grad = U.probe(t, k, need_grad=False,
                        proposal=random_walk_int_proposal(0))
    assert grad is None and got.dtype == torch.float32
    logp_dc, _ = jt.dc_forms()
    want = np.asarray(logp_dc(jnp.asarray(k.numpy().T, jnp.int32)),
                      np.float64)
    got = got.double().numpy()
    off = np.isneginf(want)
    assert (np.isneginf(got) == off).all(), (got, want)
    assert off[0] and off[1] and off[3]  # -2**20, -3 and -1
    if name.startswith("binomial"):
        assert off[-4:].all() and not off[-5]  # N + 1.. off, N on
    err = np.abs(got[~off] - want[~off]) / np.maximum(np.abs(want[~off]), 1)
    assert err.max() <= 1e-5, err.max()
    # and the port's own batch form, to float32 rounding
    torch.testing.assert_close(torch.from_numpy(got).float(),
                               t.batch_logp(k), rtol=2e-6, atol=2e-6)


def test_traced_int32_source_reads_int32_states():
    src, params = U.derive_logp_dc(binomial_target(N, P), 1, dtype=I32)
    assert "float logp(const int32_t (&x)[D])" in src
    assert "mm::lgamma(" in src and "(-INFINITY)" in src
    assert "static_cast<S>(" in src and " || " in src
    assert params == ()
    spec, tparams = U.value_spec(binomial_target(N, P),
                                 random_walk_int_proposal(0, N), 1, dtype=I32)
    assert spec.types == ("mm_user::Density", "mm::RandomWalkInt", "int32_t")
    units = U.library_sources(*spec)
    assert list(units) == ["mh", "probe"]  # no tempering at int32
    assert "launch_mh<Target, Proposal, int32_t, kDim>" in units["mh"]
    assert "state_type != mm::kI32" in units["mh"]
    assert "const int32_t* __restrict__ x" in units["probe"]
    # the float32 library of a float form keeps its text
    f32, _ = U.value_spec(F.rosenbrock_banana(), None, 2)
    assert f32.types == ("mm::User<mm_user::Density>",
                         "mm::IsotropicGaussian")
    text = "".join(U.library_sources(*f32).values())
    assert "const int32_t* __restrict__ x" not in text
    assert "kI32" not in text


def test_int_walk_source_matches_its_twin_and_the_builtin():
    x = torch.tensor([-1, 0, 1, 5, 9, 10, 11, 20] * 8, dtype=I32)[:, None]
    words = rng.stream_words(x.shape[0], 1, 3, 0x5EED, "cpu")
    for lo, hi in ((0, None), (0, N), (-5, 3)):
        walk = F.int_walk(lo, hi)
        got = U.propose_probe(walk, x, words, poisson_target(LAM))
        want = walk.propose_words(walk.cuda_params, x, words)
        assert got.dtype == I32 and torch.equal(got, want)
        # the built-in functor's own host build, as a user source
        builtin = Proposal(
            sample=walk.sample, logp=walk.logp, symmetric=True,
            cuda_source="struct Proposal : mm::RandomWalkInt {\n"
                        "  using mm::RandomWalkInt::RandomWalkInt;\n};\n",
            cuda_params=walk.cuda_params, propose_words=walk.propose_words,
            cuda_words=walk.cuda_words)
        assert torch.equal(U.propose_probe(builtin, x, words,
                                           poisson_target(LAM)), got)


def _pmf_gate(sample, pmf):
    ks = sample.reshape(-1).long()
    assert int(ks.min()) >= 0
    freq = torch.bincount(ks, minlength=11)[:11].double() / ks.numel()
    for k in range(11):
        assert abs(float(freq[k]) - pmf(k)) < 0.05, (k, float(freq[k]))


def _poisson_pmf(k):
    return math.exp(k * math.log(LAM) - LAM - math.lgamma(k + 1))


def _binomial_pmf(k):
    return math.comb(N, k) * P ** k * (1 - P) ** (N - k)


@pytest.mark.parametrize("form", ["poisson_hand", "binomial_traced",
                                  "user_walk"])
def test_int32_user_forms_pass_the_pmf_gates(form):
    # tests/test_mh.py:73-90 on the fused tier's twin (Kernel 5's plain
    # version on the CPU), 4 chains
    if form == "binomial_traced":
        t, q = binomial_target(N, P), random_walk_int_proposal(0, N)
        init, seed, pmf = torch.full((4, 1), 5, dtype=I32), 4, _binomial_pmf
    else:
        t, q = ((F.poisson_user(LAM), random_walk_int_proposal())
                if form == "poisson_hand"
                else (poisson_target(LAM), F.int_walk()))
        init, seed, pmf = torch.zeros((4, 1), dtype=I32), 42, _poisson_pmf
    mh = mt.MetropolisHastings(t, q, init, use_pallas="full",
                               steps_per_call=10, **CPU).seed(seed)
    sample = mh.run(10000, 2000)
    assert sample.dtype == I32 and mh.state.logp.dtype == torch.float32
    _pmf_gate(sample, pmf)
    if form == "user_walk":  # the same words: the built-in walk's cube
        ref = mt.MetropolisHastings(
            t, random_walk_int_proposal(), init, use_pallas="full",
            steps_per_call=10, **CPU).seed(seed).run(10000, 2000)
        assert torch.equal(sample, ref)


def test_validate_dc_catches_wrong_int32_sources_and_twins():
    k = torch.arange(0, N + 1, dtype=I32)[:, None]
    walk = random_walk_int_proposal(0, N)
    for t in (F.poisson_user(LAM), binomial_target(N, P)):
        validate_dc_forms(t, k, need_grad=False, proposal=walk)
    # a wrong coefficient
    wrong = Target(logp=poisson_target(LAM).logp,
                   cuda_source=F.POISSON_SOURCE.replace(
                       "__fmul_rn(kf, log_lam)",
                       "__fmul_rn(kf, 1.01f * log_lam)"),
                   cuda_params=poisson_target(LAM).cuda_params)
    with pytest.raises(ValueError, match="disagrees with its batch form"):
        validate_dc_forms(wrong, k, need_grad=False, proposal=walk)
    # a support too wide: the uniform on 0..N without its upper edge,
    # caught on the probe's row past the positions' greatest (N + 1)
    def uniform(x):
        k = x[..., 0]
        return torch.where((k < 0) | (k > N), -math.inf,
                           -math.log(N + 1.0))

    edge = """
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}
  template <int D>
  __device__ __forceinline__ float logp(const int32_t (&x)[D]) const {
    if (x[0] < 0%s) return -INFINITY;
    return -mm::log(%d.0f);
  }
};
"""
    validate_dc_forms(Target(logp=uniform, cuda_source=edge % (
        f" || x[0] > {N}", N + 1)), k, need_grad=False, proposal=walk)
    with pytest.raises(ValueError, match="disagrees with its batch form"):
        validate_dc_forms(Target(logp=uniform, cuda_source=edge % (
            "", N + 1)), k, need_grad=False, proposal=walk)
    # a twin that walks another way
    good = F.int_walk(0, N)

    def off(params, current, words):
        return torch.clamp(good.propose_words(params, current, words) + 1,
                           max=N)

    wrong_twin = Proposal(sample=good.sample, logp=good.logp, symmetric=True,
                          cuda_source=good.cuda_source,
                          cuda_params=good.cuda_params, propose_words=off,
                          cuda_words=good.cuda_words)
    with pytest.raises(ValueError, match="compiled proposal"):
        validate_proposal_dc(wrong_twin, poisson_target(LAM), k)
    validate_proposal_dc(good, poisson_target(LAM), k)


def test_traced_int32_refusals_name_the_op():
    def mod(x):
        k = x[..., 0]
        return torch.where(torch.remainder(k, 2) == 0, 0.0, -1.0)

    with pytest.raises(ValueError, match="remainder"):
        U.derive_logp_dc(Target(logp=mod), 1, dtype=I32)
    with pytest.raises(ValueError, match="float64"):
        U.derive_logp_dc(Target(logp=lambda x: x[..., 0].double() * 0.5),
                         1, dtype=I32)
    with pytest.raises(ValueError, match="cumsum"):
        U.derive_logp_dc(Target(
            logp=lambda x: torch.cumsum(x.float(), -1)[..., -1]), 2,
            dtype=I32)
    # a float32 density keeps refusing what it refused
    with pytest.raises(ValueError, match="lgamma"):
        U.derive_logp_dc(Target(logp=lambda x: torch.lgamma(x).sum(-1)), 2)


def test_int32_instances_and_their_refusals():
    walk = random_walk_int_proposal(0)
    assert mh_instance(F.poisson_user(LAM), walk, I32, 1) == (-1, -1, 1)
    assert mh_instance(poisson_target(LAM), F.int_walk(), I32, 1) == (
        -1, -1, 1)
    # an int32 state takes no transform
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=1)
    with pytest.raises(ValueError, match="no transform"):
        mh_instance(tf.wrap(F.poisson_user(LAM)), walk, I32, 1)
    # a float functor beside an int32 user proposal, and the int walk
    # beside a float32 user density: each names what that dtype takes
    with pytest.raises(ValueError, match="int32 states"):
        U.value_spec(mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                     F.int_walk(), 2, dtype=I32)
    with pytest.raises(ValueError, match="float32 states"):
        U.value_spec(F.rosenbrock_banana(), walk, 2)
