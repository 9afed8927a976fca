"""User forms in the MH kernel (Kernel 5): user densities read by value
and user proposals (``Proposal.cuda_source`` with its twin
``propose_words``), built for the host with ``g++`` through
``csrc/host_shim.h`` (the text nvcc compiles), against the JAX package's
chains-on-lanes forms and the ports' PyTorch twins on seeded numpy inputs.

Tolerances: a density's value at rtol 3e-4 with atol 1e-4 x max(|want|,
1), the JAX package's ``validate_dc_forms`` rule (float32 on both sides,
other summation orders, libm against XLA by an ulp or two). A compiled
proposal against its PyTorch twin within 8 float32 ulps of the result
(glibc's ``logf``/``sincosf`` on the host against PyTorch's vectorised CPU
kernels, each within an ulp or two); the user source that copies
``IsotropicGaussian`` against the built-in functor's own host build bit
for bit (the same text through the same compiler); the samplers' moments
within 5 standard errors of the truth, for both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import mini_mcmc_tpu as jmt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import Proposal, Target
from mini_mcmc_torch.models.base import (
    validate_dc_forms,
    validate_proposal_dc,
)
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_torch.ops.kernels.mh_full import (
    mh_instance,
    mh_multistep_plain,
    propose_form,
)
from mini_mcmc_tpu import models as jm

RTOL, ATOL = 3e-4, 1e-4
CPU = dict(device="cpu")
MEAN = [0.5, -1.0]
COV = [[1.0, 0.3], [0.3, 2.0]]

# a density at any D: -sum(((x - 0.25) / s)^2) / 2 + 0.1 sum(cos x), s_d =
# 0.5 + 0.25 d; the hand source does the same arithmetic per coordinate
WAVY_SOURCE = """
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}
  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S acc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const S z = (x[d] - 0.25f) / (0.5f + 0.25f * (float)d);
      acc = acc - 0.5f * (z * z) + 0.1f * mm::cos(x[d]);
    }
    return acc;
  }
};
"""


def _wavy_port(hand: bool) -> Target:
    def logp(x):
        s = 0.5 + 0.25 * torch.arange(x.shape[-1], dtype=x.dtype)
        z = (x - 0.25) / s
        return torch.sum(-0.5 * (z * z) + 0.1 * torch.cos(x), dim=-1)

    return Target(logp=logp, cuda_source=WAVY_SOURCE if hand else None)


def _wavy_jax():
    def logp(x):
        s = 0.5 + 0.25 * jnp.arange(x.shape[-1], dtype=x.dtype)
        z = (x - 0.25) / s
        return jnp.sum(-0.5 * (z * z) + 0.1 * jnp.cos(x), axis=-1)

    return jm.Target(logp=logp, logp_batch=logp)


def _points(c, d, seed, scale=1.5):
    g = np.random.default_rng(seed)
    return (scale * g.standard_normal((c, d))).astype(np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _jax_value(jt, x):
    """JAX's chains-on-lanes logp_dc (``Target.dc_forms()[0]``, derived
    from the batch form) at the rows of ``x``."""
    return np.asarray(jt.dc_forms()[0](jnp.asarray(x.T)))


@pytest.mark.parametrize("dim", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("hand", [True, False], ids=["hand", "traced"])
def test_user_density_values_match_the_jax_dc_form(dim, hand):
    """The value-only probe (Kernels 5 and 8 read the value alone) of the
    hand source and of the traced batch form against JAX's logp_dc."""
    x = _points(48, dim, seed=dim)
    t = _wavy_port(hand)
    lp, grad = U.probe(t, torch.from_numpy(x), need_grad=False)
    assert grad is None
    _close(lp, _jax_value(_wavy_jax(), x), f"logp D={dim}")
    validate_dc_forms(t, torch.from_numpy(x), need_grad=False)


def test_gaussian2d_sources_match_the_builtin_twin():
    """examples/user_forms.py's hand Gaussian2D (a copy of
    targets.cuh:Gaussian2D) and the traced one against the built-in
    functor's twin and JAX's Gaussian2D logp_dc."""
    x = _points(64, 2, seed=7)
    want = mt.gaussian2d(MEAN, COV).batch_logp(torch.from_numpy(x))
    for hand in (True, False):
        t = F.gaussian2d_user(MEAN, COV, hand)
        lp, _ = U.probe(t, torch.from_numpy(x), need_grad=False)
        _close(lp, want, f"hand={hand}")
        _close(lp, _jax_value(jm.gaussian2d(jnp.asarray(MEAN),
                                            jnp.asarray(COV)), x), "jax")


def _builtin_copy(name: str) -> str:
    """A user source that is the built-in functor ``name`` itself: its
    host build is the built-in's arithmetic through the same compiler."""
    return (f"struct Proposal : mm::{name} {{\n"
            f"  using mm::{name}::{name};\n}};\n")


@pytest.mark.parametrize("dim", [1, 2, 3, 5])
def test_user_proposals_against_their_twins_and_the_builtin(dim):
    x = torch.from_numpy(_points(256, dim, seed=10 + dim))
    iso = F.isotropic_walk(0.7)
    words = rng.stream_words(256, iso.cuda_words(dim), 4, 0x5EED_1717)
    got = U.propose_probe(iso, x, words, None)
    twin = iso.propose_words(iso.cuda_params, x, words)
    ulp = torch.finfo(torch.float32).eps * twin.abs().clamp(min=1.0)
    assert bool(((got - twin).abs() <= 8 * ulp).all())
    # the copy of IsotropicGaussian is the built-in functor bit for bit
    builtin = Proposal(sample=iso.sample, logp=iso.logp, symmetric=True,
                       cuda_source=_builtin_copy("IsotropicGaussian"),
                       cuda_params=iso.cuda_params,
                       propose_words=iso.propose_words,
                       cuda_words=iso.cuda_words)
    assert torch.equal(got, U.propose_probe(builtin, x, words, None))
    # the built-in twin draws as the user twin does
    words_of, propose = propose_form(mt.isotropic_gaussian_proposal(0.7))
    assert words_of(dim) == iso.cuda_words(dim)
    assert torch.equal(propose((0.7,), x, words), twin)
    scaled = F.scaled_walk([0.5 + 0.5 * d for d in range(dim)])
    got = U.propose_probe(scaled, x, words, None)
    twin = scaled.propose_words(scaled.cuda_params, x, words)
    ulp = torch.finfo(torch.float32).eps * twin.abs().clamp(min=1.0)
    assert bool(((got - twin).abs() <= 8 * ulp).all())
    validate_proposal_dc(scaled, None, x)


def test_a_copied_walk_gives_the_builtin_twins_cube():
    """Kernel 5's twin with the user isotropic walk and the hand Gaussian2D
    source gives the built-in pair's cube bit for bit: the same words, the
    same arithmetic."""
    x = torch.from_numpy(_points(512, 2, seed=3))
    g = mt.gaussian2d(MEAN, COV)
    cubes = []
    for target, walk in ((g, mt.isotropic_gaussian_proposal(1.1)),
                         (F.gaussian2d_user(MEAN, COV), F.isotropic_walk(1.1)),
                         (g, F.isotropic_walk(1.1))):
        hist = torch.empty((16, 512, 2))
        mh_multistep_plain(target, walk, x, g.batch_logp(x), 0x5EED_2121, 7,
                           16, hist)
        cubes.append(hist)
    assert torch.equal(cubes[0], cubes[1]) and torch.equal(cubes[0],
                                                           cubes[2])
    s = mt.MetropolisHastings(g, F.isotropic_walk(1.1), x, use_pallas="full",
                              steps_per_call=4, **CPU).seed(5).run(16)
    b = mt.MetropolisHastings(g, mt.isotropic_gaussian_proposal(1.1), x,
                              use_pallas="full", steps_per_call=4,
                              **CPU).seed(5).run(16)
    assert torch.equal(s, b)


def _moments_within(sample, mean, var, n_eff, what):
    flat = sample.reshape(-1, sample.shape[-1]).double()
    m, v = flat.mean(0), flat.var(0)
    se_m = torch.sqrt(torch.as_tensor(var, dtype=torch.float64) / n_eff)
    assert bool(((m - torch.as_tensor(mean)).abs() <= 5 * se_m).all()), (
        what, m)
    assert bool(((v / torch.as_tensor(var) - 1).abs() <= 0.1).all()), (
        what, v)


def test_mh_with_user_forms_passes_the_gates_of_the_jax_xla_path():
    """Both packages sample the Gaussian2D: the port's fused tier's twin
    with the traced density and the scaled user walk, the JAX package's
    XLA tier with its isotropic walk; the same moment gates."""
    x0 = _points(1024, 2, seed=11, scale=1.0) + np.asarray(MEAN, np.float32)
    var = [COV[0][0], COV[1][1]]
    port = mt.MetropolisHastings(
        F.gaussian2d_user(MEAN, COV, hand=False), F.scaled_walk([1.6, 2.2]),
        x0, use_pallas="full", steps_per_call=8, **CPU).seed(2)
    _moments_within(port.run(256, 64), MEAN, var, 1024 * 256 / 8.0, "port")
    jax_mh = jmt.MetropolisHastings(
        jm.gaussian2d(jnp.asarray(MEAN), jnp.asarray(COV)),
        jm.isotropic_gaussian_proposal(1.8), jnp.asarray(x0)).seed(2)
    _moments_within(torch.from_numpy(np.array(jax_mh.run(256, 64))),
                    MEAN, var, 1024 * 256 / 8.0, "jax")


def test_refusals_name_the_missing_field():
    g = mt.gaussian2d(MEAN, COV)
    walk = F.isotropic_walk(1.0)
    # a proposal with a twin but no source runs on the CPU only
    twin_only = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True,
                         propose_words=walk.propose_words,
                         cuda_words=walk.cuda_words)
    assert propose_form(twin_only)[0] is walk.cuda_words
    with pytest.raises(ValueError, match="Proposal.cuda_source"):
        mh_instance(g, twin_only, torch.float32, 2)
    with pytest.raises(ValueError, match="propose_words"):
        propose_form(Proposal(sample=walk.sample, logp=walk.logp,
                              symmetric=True, cuda_source="struct P {};"))
    with pytest.raises(ValueError, match="not both"):
        Proposal(sample=walk.sample, logp=walk.logp,
                 cuda_functor="isotropic_gaussian", cuda_source="x")
    # user forms: float32 (or int32) states, D <= 16
    assert mh_instance(Target(logp=g.logp), walk, torch.float32, 2) == (
        -1, -1, 0)
    with pytest.raises(ValueError, match="does not take float64"):
        mh_instance(Target(logp=g.logp), walk, torch.float64, 2)
    with pytest.raises(ValueError, match="D <= 16"):
        mh_instance(Target(logp=g.logp), walk, torch.float32, 17)


def test_the_value_probe_uses_the_library_mh_launches():
    """A user density beside the built-in walk shares tempering's library;
    beside a user proposal it has its own, which validate_dc_forms probes
    when given the proposal; a built-in proposal with no float32 instance
    raises rather than running another walk."""
    from mini_mcmc_torch.models.discrete import random_walk_int_proposal

    t = F.rosenbrock_banana()
    alone = U.value_spec(t, None, 2)[0]
    assert U.value_spec(t, mt.isotropic_gaussian_proposal(0.5), 2)[0] == alone
    assert U.value_spec(t, F.isotropic_walk(0.5), 2)[0] != alone
    with pytest.raises(ValueError, match="random_walk_int.*float32"):
        U.value_spec(t, random_walk_int_proposal(), 2)
    x = torch.from_numpy(_points(64, 2, seed=9))
    validate_dc_forms(t, x, need_grad=False, proposal=F.isotropic_walk(0.5))


def test_mh_lib_asks_for_the_pairs_library(monkeypatch):
    """mh_lib passes the proposal itself, built-in or user, to the value
    library (the pair's own Spec)."""
    from mini_mcmc_torch.ops.kernels import mh_full

    asked = []
    monkeypatch.setattr(U, "value_lib", lambda t, p, d, dev, dtype: (
        asked.append((t, p, d)) or (None, 0)))
    t = F.rosenbrock_banana()
    for p in (mt.isotropic_gaussian_proposal(0.5), F.isotropic_walk(0.5)):
        mh_full.mh_lib(t, p, torch.float32, 2, "cpu")
        assert asked[-1] == (t, p, 2)


def test_validate_dc_catches_a_wrong_twin_a_wrong_source_and_words():
    x = torch.from_numpy(_points(64, 2, seed=5))
    walk = F.isotropic_walk(1.0)

    def off(params, current, words):
        return walk.propose_words(params, current, words) * 1.001

    wrong_twin = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True,
                          cuda_source=walk.cuda_source, cuda_params=(1.0,),
                          propose_words=off, cuda_words=walk.cuda_words)
    with pytest.raises(ValueError, match="compiled proposal"):
        validate_proposal_dc(wrong_twin, None, x)
    bad_words = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True,
                         cuda_source=walk.cuda_source, cuda_params=(1.0,),
                         propose_words=walk.propose_words,
                         cuda_words=lambda d: 2 * d + 2)
    with pytest.raises(ValueError, match="cuda_words"):
        validate_proposal_dc(bad_words, None, x)
    wrong = Target(logp=_wavy_port(True).logp,
                   cuda_source=WAVY_SOURCE.replace("0.1f", "0.2f"))
    with pytest.raises(ValueError, match="compiled logp"):
        validate_dc_forms(wrong, x, need_grad=False)
