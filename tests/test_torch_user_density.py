"""User densities for Kernels 1-4 (``ops/kernels/user_density.py``): the
C++ of a ``Target.cuda_source``, of its gradient by dual numbers and of the
code generated from a batch form, built for the host with ``g++`` through
``csrc/host_shim.h`` (the text nvcc compiles), against the JAX package's
chains-on-lanes forms on the same seeded numpy inputs.

Tolerance: rtol 3e-4 with atol 1e-4 x max(|want|, 1), the rule of the JAX
package's ``validate_dc_forms`` (``mini_mcmc_tpu/models/base.py:309-313``):
both sides are float32 but sum their terms in other orders, and libm's
``expf``/``log1pf`` and XLA's differ by an ulp or two.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import eight_schools as es
from mini_mcmc_torch.models import (
    CoordinateTransform,
    Preconditioner,
    Target,
    derive_grad_dc,
    derive_logp_dc,
    positive,
    precondition_target,
    validate_dc_forms,
)
from mini_mcmc_torch.ops.kernels import _build
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models.base import derive_grad_dc as jax_derive_grad_dc

RTOL, ATOL = 3e-4, 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _jax_eight_schools():
    spec = importlib.util.spec_from_file_location(
        "es8", ROOT / "examples" / "eight_schools_nuts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_noncentered_target()


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _points(c, d, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return (scale * g.standard_normal((c, d))).astype(np.float32)


def _jax_forms(jt, x, hand_grad: bool):
    """JAX's logp_dc and, hand-written or derived by AD, grad_dc at the
    rows of ``x`` (float32)."""
    xd = jnp.asarray(x.T, jnp.float32)
    grad_dc = jt.grad_dc if hand_grad else jax_derive_grad_dc(jt.logp_dc)
    return np.asarray(jt.logp_dc(xd)), np.asarray(grad_dc(xd)).T


@pytest.mark.parametrize("form", es.CUDA_FORMS)
def test_eight_schools_sources_match_the_jax_dc_forms(form):
    """The hand-written source against the example's logp_dc and grad_dc,
    the dual-number gradient and the traced source against
    derive_grad_dc(logp_dc), on [64, 10] inputs."""
    x = _points(64, 10, seed=3)
    x[:, 1] = np.clip(x[:, 1], -3.0, 3.0)  # log tau
    t = es.make_noncentered_target(form)
    forms = t.dc_forms(10)
    assert forms.grad == ("hand" if form == "hand" else "derived")
    assert forms.traced == (form == "traced")
    lp, g = U.probe(t, torch.from_numpy(x))
    want_lp, want_g = _jax_forms(_jax_eight_schools(), x, form == "hand")
    _close(lp, want_lp, "logp")
    _close(g, want_g, "grad")


@pytest.mark.parametrize("name, dim", [("rosenbrock", 3), ("rosenbrock", 10),
                                       ("funnel", 4), ("funnel", 10)])
def test_traced_rosenbrock_and_funnel_match_the_jax_dc_forms(name, dim):
    if name == "rosenbrock":
        t = Target(logp=mt.rosenbrock_nd().logp)
        jt = jm.rosenbrock_nd()
        x = _points(64, dim, seed=dim, scale=0.6) + 0.5
    else:
        t = Target(logp=mt.neal_funnel(3.0).logp)
        jt = jm.neal_funnel(3.0)
        x = _points(64, dim, seed=dim)
    source, params = derive_logp_dc(t, dim)
    assert "Density" in source and f"D == {dim}" in source
    lp, g = U.probe(t, torch.from_numpy(x))
    want_lp, want_g = _jax_forms(jt, x, hand_grad=False)
    _close(lp, want_lp, "logp")
    _close(g, want_g, "grad")


def test_traced_constants_ride_in_the_params():
    """The data of the batch form (Y, SIGMA) come through as tensor
    constants appended to cuda_params, read with __ldg."""
    t = es.make_noncentered_target("traced")
    source, params = derive_logp_dc(t, 10)
    assert "__ldg(p_ + 0" in source and "__ldg(p_ + 8" in source
    np.testing.assert_array_equal(np.asarray(params, np.float32),
                                  np.concatenate([es.Y, es.SIGMA]))
    # a second trace is the same text: the library cache keys on it
    assert derive_logp_dc(t, 10) == (source, params)


def _sigmoid_density(x):
    return -torch.sum(torch.sigmoid(x) ** 2, dim=-1)


@pytest.mark.parametrize("logp, match", [
    (_sigmoid_density, "sigmoid"),
    (lambda x: -torch.sum(torch.cumsum(x, dim=1), dim=1), "cumsum"),
    # the counterpart of test_cross_lane_reduction_logp_dc_caught_by_grad
    # _probe: value-preserving coupling across chains
    (lambda x: (lambda lp: lp * (lp.sum() / lp.sum().detach()))(
        -torch.sum(x * x, dim=1)), "chain axis"),
    (lambda x: -torch.sum((x - x.sum(0, keepdim=True)) ** 2, dim=1),
     "chain axis"),
    (lambda x: -torch.sum(x.reshape(-1) ** 2).expand(x.shape[0]),
     "chain axis"),
    (lambda x: -torch.sum(x[1:] ** 2, dim=1), "chain axis"),
], ids=["sigmoid", "cumsum", "sum-over-chains", "centred", "flatten",
        "chain-slice"])
def test_generator_raises_outside_its_table(logp, match):
    t = Target(logp=logp)
    with pytest.raises(ValueError, match=match) as err:
        t.dc_forms(4)
    assert "cuda_source" in str(err.value)


def test_generated_source_covers_the_op_table():
    """Every operation of the table in one density against autograd."""
    w = torch.linspace(-0.5, 0.5, 12).reshape(4, 3)
    b = torch.tensor([0.3, -0.2, 0.1])

    def logp(x):  # [C, 4] -> [C]
        h = torch.tanh(x @ w + b)  # mm against a constant, broadcast add
        u = x.unsqueeze(2).expand(-1, 4, 3)[:, :, 1]  # expand, select
        v = x.view(-1, 2, 2).reshape(x.shape[0], 4)
        terms = (torch.exp(-x * x) + torch.log1p(x * x) + torch.expm1(
            0.1 * x) + torch.sqrt(1.0 + x * x) + torch.sin(x) * torch.cos(v)
            + torch.abs(x - 0.1) + torch.minimum(x, u) - torch.maximum(
                x, 0.2 * u) + torch.log(2.0 + x * x) / (1.5 + x * x)
            + (1.0 + x * x) ** 1.5 + torch.reciprocal(2.0 + x * x)
            - torch.square(x) - torch.neg(u))
        return terms.sum(-1) + h.sum(-1) + x[:, 1:3].sum(-1) + (
            x @ b.new_tensor([1.0, 2.0, 3.0, 4.0]))

    t = Target(logp=logp)
    x = torch.from_numpy(_points(32, 4, seed=9))
    lp, g = U.probe(t, x)
    want_lp, want_g = t.batch_logp_and_grad(x)
    _close(lp, want_lp, "logp")
    _close(g, want_g, "grad")


def _broken(old: str, new: str) -> Target:
    assert old in es.CUDA_SOURCE
    good = es.make_noncentered_target("hand")
    return Target(logp=good.logp, logp_batch=good.logp_batch,
                  grad=good.grad, cuda_params=good.cuda_params,
                  cuda_source=es.CUDA_SOURCE.replace(old, new))


def test_validator_catches_a_wrong_term_and_a_wrong_gradient():
    """The counterparts of tests/test_pallas.py:545-633: a dropped-scale
    term in logp, a wrong sign in the hand-written grad, each raises, and
    so does the corrupted logp with the dual-number gradient;
    need_grad=False skips the gradient only."""
    x = torch.from_numpy(_points(32, 10, seed=5))
    for form in es.CUDA_FORMS:
        validate_dc_forms(es.make_noncentered_target(form), x)
    wrong_logp = _broken("acc = acc - 0.5f * eta * eta;",
                         "acc = acc - 0.45f * eta * eta;")
    with pytest.raises(ValueError, match="compiled logp"):
        validate_dc_forms(wrong_logp, x)
    wrong_grad = _broken("g[2 + j] = r * tau - eta;",
                         "g[2 + j] = eta - r * tau;")
    with pytest.raises(ValueError, match=r"compiled grad \(hand\)"):
        validate_dc_forms(wrong_grad, x)
    validate_dc_forms(wrong_grad, x, need_grad=False)
    derived = Target(logp=wrong_logp.logp, grad=wrong_logp.grad,
                     cuda_params=wrong_logp.cuda_params,
                     cuda_source=derive_grad_dc(wrong_logp.cuda_source))
    with pytest.raises(ValueError, match=r"compiled logp"):
        validate_dc_forms(derived, x)


def test_a_source_that_does_not_compile_raises_with_the_compiler_output():
    bad = Target(logp=lambda x: -x.pow(2).sum(-1),
                 cuda_source="struct Density { not c++ };")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        U.probe(bad, torch.zeros((2, 3)))


def test_a_target_names_a_functor_or_a_source():
    with pytest.raises(ValueError, match="not both"):
        Target(logp=lambda x: x.sum(-1), cuda_functor="rosenbrock_nd",
               cuda_source="struct Density {};")
    with pytest.raises(ValueError, match="built in"):
        mt.rosenbrock_nd().dc_forms(3)
    with pytest.raises(ValueError, match="D <= 16"):
        Target(logp=lambda x: -x.pow(2).sum(-1)).dc_forms(17)


@pytest.mark.parametrize("form", es.CUDA_FORMS)
def test_metric_wrappers_carry_the_source(form):
    """A diagonal metric above D = 4 enters as D scales
    (mm::WhitenedDiag, wrapper bit 2); a dense one as L's triangle; both
    around the user functor, held to the whitened batch form."""
    t = es.make_noncentered_target(form)
    y = torch.from_numpy(_points(32, 10, seed=11))
    scale = torch.linspace(0.5, 2.0, 10)
    g = np.random.default_rng(2)
    a = g.standard_normal((10, 10)) * 0.1
    chol = torch.from_numpy(np.linalg.cholesky(a @ a.T + np.eye(10)))
    for metric, flags, head in (
            (Preconditioner("diag", scale=scale), 5, 10),
            (Preconditioner("dense", chol=chol.float()), 1, 55)):
        w = precondition_target(t, metric)
        assert _build.instance_flags(w) == flags
        assert _build.wrapper_floats(w, 10) == head
        assert w.cuda_source == t.cuda_source
        assert (w.cuda_base is t) == (form == "traced")
        forms = w.dc_forms(10)
        assert len(forms.params) == head + 16
        lp, gr = U.probe(w, y)
        want_lp, want_g = w.batch_logp_and_grad(y)
        _close(lp, want_lp, f"{metric.kind} logp")
        _close(gr, want_g, f"{metric.kind} grad")
    # diag metrics at D <= 4 stay a triangle of L (the built-in instances)
    small = precondition_target(Target(logp=mt.rosenbrock_nd().logp),
                                Preconditioner("diag", scale=scale[:3]))
    assert _build.instance_flags(small) == 1 and not small.cuda_diag


def test_transform_carries_the_source_at_d10():
    """The natural eight-schools target under positive() on tau, traced:
    mm::Transformed<mm::User<Density>, 10> (its table in the params up
    to D = 16) against the wrapped batch form."""
    tf = CoordinateTransform({1: positive()}, dim=10)
    w = tf.wrap(es.make_natural_target())
    assert _build.instance_flags(w) == 2
    assert _build.wrapper_floats(w, 10) == _build.TRANSFORM_HEAD + 30
    y = _points(32, 10, seed=12)
    y[:, 1] = np.clip(y[:, 1], -3.0, 3.0)
    y = torch.from_numpy(y)
    lp, g = U.probe(w, y)
    want_lp, want_g = w.batch_logp_and_grad(y)
    _close(lp, want_lp, "logp")
    _close(g, want_g, "grad")


def test_cpu_samplers_neither_trace_nor_compile(monkeypatch):
    """On the CPU the fused tiers run their plain twins on batch_logp: no
    trace, no build, even for a target the generator would refuse."""
    def refuse(*a, **k):
        raise AssertionError("traced or built on the CPU")

    monkeypatch.setattr(U, "derive_logp_dc", refuse)
    monkeypatch.setattr(U, "build", refuse)
    t = Target(logp=_sigmoid_density)
    x = mt.init_with_seed(16, 3, seed=1, device="cpu")
    mt.HMC(t, x, 0.1, 3, use_pallas="full", device="cpu").seed(1).run(2)
    mt.NUTS(t, x, 0.8, use_pallas="full", device="cpu").seed(1).run(2, 2)


def test_library_name_hashes_source_dim_and_bits():
    p = U.library_path(es.CUDA_SOURCE, 10, 0)
    assert p == U.library_path(es.CUDA_SOURCE, 10, 0)
    assert len({p, U.library_path(es.CUDA_SOURCE, 10, 5),
                U.library_path(es.CUDA_SOURCE, 9, 0),
                U.library_path(derive_grad_dc(es.CUDA_SOURCE), 10, 0)}) == 4
    units = U.library_sources(es.CUDA_SOURCE, 10, 5)
    assert set(units) == {"leapfrog", "multistep", "subtree", "step"}
    assert all("mm::WhitenedDiag<mm::User<mm_user::Density>, 10>" in u
               for u in units.values())
    assert U.instance_type(10, 7) == (
        "mm::WhitenedDiag<mm::Transformed<mm::User<mm_user::Density>, 10>,"
        " 10>")
