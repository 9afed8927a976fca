"""The transform layer (``models/transforms.py``) in the port against the
JAX package on the same numpy inputs, ``transform=`` on HMC, MALA, NUTS, MH
and tempering through the plain twins of Kernels 1-4 and 7, ``neal_funnel``
and ``convert``'s transforms.

Tolerances: the bijectors in float32 against JAX pinned to float32 (the
suite enables x64) at rtol 1e-6 / atol 1e-6, in float64 at 1e-12, on a grid
over [-1e4, 1e4] and the saturation edges. Beyond the soft saturation's
core an exp-family value or derivative is held to that tolerance plus
eight ulps of ``|x - offset| (1 + |y'|)``: XLA's float32 and float64 tanh
differ from PyTorch's by one to three ulps there, and ``exp(y')`` (``y'``
up to 79.85 in float32) turns one ulp of ``y'`` into that relative error,
as ``(1 - tanh u)`` does for the derivative; log-Jacobians, interval maps
and everything in the core are held to the plain tolerance. The closed-form
derivatives, which the CUDA kernels evaluate, are held to autograd of the
plain version in float64 at 1e-12 everywhere. The wrapped densities at
rtol 1e-5; Kernels 1, 3 and 7's twins against the Pallas kernels in
interpret mode as ``tests/test_torch_precondition.py`` and
``tests/test_torch_separable.py`` hold them (1e-5).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    mh_sampler_kwargs,
    nuts_sampler_kwargs,
    pt_sampler_kwargs,
    sampler_kwargs,
    transform_from_jax,
)
from mini_mcmc_torch.models import (
    Bijector,
    CoordinateTransform,
    Preconditioner,
    Target,
    identity,
    interval,
    isotropic_gaussian_proposal,
    lower_bounded,
    positive,
    precondition_target,
    transformed_target,
    upper_bounded,
)
from mini_mcmc_torch.models import transforms as T
from mini_mcmc_torch.ops.kernels import _build
from mini_mcmc_torch.ops.kernels.hmc import leapfrog_trajectory
from mini_mcmc_torch.ops.kernels.hmc_sep import (
    hmc_separable,
    hmc_separable_plain,
    sep_functor,
    sep_instance,
)
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree, subtree_plain
from mini_mcmc_tpu import HMC as JaxHMC
from mini_mcmc_tpu import NUTS as JaxNUTS
from mini_mcmc_tpu import MetropolisHastings as JaxMH
from mini_mcmc_tpu import ParallelTempering as JaxPT
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models import transforms as J
from mini_mcmc_tpu.ops.pallas.hmc import make_pallas_leapfrog
from mini_mcmc_tpu.ops.pallas.hmc_bigd import make_pallas_hmc_separable
from mini_mcmc_tpu.ops.pallas.nuts_subtree import make_pallas_subtree

torch.set_num_threads(1)

CPU = dict(device="cpu")
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
TOL = {np.float32: 1e-6, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}
#: (port factory, JAX factory, arguments, squash)
BIJECTORS = {
    "positive": (positive, J.positive, (), T._EXP_LIM),
    "lower": (lower_bounded, J.lower_bounded, (-1.5,), T._EXP_LIM),
    "upper": (upper_bounded, J.upper_bounded, (2.0,), T._EXP_LIM),
    "interval01": (interval, J.interval, (0.0, 1.0), T._SIG_LIM),
    "interval": (interval, J.interval, (-0.7, 3.1), T._SIG_LIM),
}


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _grid(dtype, squash):
    """[-1e4, 1e4] in steps of 10, zero, and the saturation edges: the
    core's half-width a (in ``dtype``), a +- 1e-3, +-50, +-200, +-1e4."""
    a = float(dtype(squash.params(TORCH[dtype])[0]))
    edges = [a, a + 1e-3, a - 1e-3, 50.0, 200.0, 1e4]
    return np.concatenate([np.linspace(-1e4, 1e4, 2001), [0.0], edges,
                           [-e for e in edges]]).astype(dtype), a


def _bijectors(name):
    port, jax_f, args, squash = BIJECTORS[name]
    return port(*args), jax_f(*args), squash


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_matches_jax(name, dtype):
    tb, jb, squash = _bijectors(name)
    y, a = _grid(dtype, squash)
    tol, eps = TOL[dtype], np.finfo(dtype).eps
    with jax.enable_x64(dtype == np.float64):
        jy = jnp.asarray(y)
        want = {"forward": jb.forward(jy), "log_det": jb.log_det(jy),
                "dforward": J._elem_grad(jb.forward)(jy),
                "dlog_det": J._elem_grad(jb.log_det)(jy)}
        want = {k: np.asarray(v) for k, v in want.items()}
        core = np.abs(y) <= a - 1.0
        x_core = np.asarray(jb.forward(jnp.asarray(y[core])))
        inv_want = np.asarray(jb.inverse(jnp.asarray(x_core)))
    yt = torch.from_numpy(y)
    got = {k: _np(getattr(tb, k)(yt)) for k in want}
    offset = tb.cuda[1]
    x64 = want["forward"].astype(np.float64)
    pre = squash.pre(yt.double()).numpy()
    beyond = np.abs(y) > a
    # one ulp of y' through exp (or of tanh through 1 - tanh u) beyond the
    # core: eight ulps of |x - offset| (1 + |y'|), the module docstring
    slack = np.where(beyond & (tb.cuda[0] != T.BIJ_INTERVAL),
                     8 * eps * np.abs(x64 - offset) * (1.0 + np.abs(pre)),
                     0.0)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype == dtype, (key, g.dtype, w.dtype)
        assert np.isfinite(g).all(), key
        allowed = tol + tol * np.abs(w) + (
            slack if key in ("forward", "dforward") else 0.0)
        err = np.abs(g.astype(np.float64) - w) - allowed
        assert (err <= 0).all(), (key, y[err > 0][:5], g[err > 0][:5],
                                  w[err > 0][:5])
    # the inverse on the core's image, and the round trip where an offset
    # does not swallow exp(y)
    inv = _np(tb.inverse(torch.from_numpy(x_core.copy())))
    np.testing.assert_allclose(inv, inv_want, rtol=tol, atol=tol)
    near = np.abs(y[core]) <= 5.0
    np.testing.assert_allclose(inv[near], y[core][near], rtol=100 * tol,
                               atol=100 * tol)


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_closed_form_derivatives_match_autograd_in_float64(name):
    """The closed forms the kernels evaluate (csrc/targets.cuh:bij_grad)
    against autograd of the plain maps, in the core, at +-a and +-a +-
    1e-3, at +-50, +-200 and +-1e4 (and the whole grid)."""
    tb, _, squash = _bijectors(name)
    y, a = _grid(np.float64, squash)
    yt = torch.from_numpy(y)
    for closed, f in ((tb.dforward, tb.forward), (tb.dlog_det, tb.log_det)):
        got, want = _np(closed(yt)), _np(T._elem_grad(f)(yt))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # at +-a both take the core's value: pre' = 1, no saturation term
    edge = torch.tensor([a, -a], dtype=torch.float64)
    np.testing.assert_array_equal(_np(squash.dpre(edge)), [1.0, 1.0])
    np.testing.assert_array_equal(_np(squash.dpre_log_det(edge)), [0.0, 0.0])


def test_interval_validates_bounds_and_factories_are_cached():
    with pytest.raises(ValueError, match="high > low"):
        interval(2.0, 2.0)
    assert positive() is positive() and interval(0, 1) is interval(0.0, 1.0)
    assert lower_bounded(2.0) is not lower_bounded(3.0)
    assert identity().cuda == (T.BIJ_IDENTITY, 0.0, 0.0)
    assert upper_bounded(2.0).cuda == (T.BIJ_UPPER, 2.0, -1.0)
    assert interval(-0.7, 3.1).cuda == (T.BIJ_INTERVAL, -0.7, 3.1 + 0.7)


def _mixed(dim=6):
    table = {0: positive(), 2: interval(0.0, 1.0), 3: lower_bounded(-1.0),
             4: upper_bounded(2.0)}
    jtable = {0: J.positive(), 2: J.interval(0.0, 1.0),
              3: J.lower_bounded(-1.0), 4: J.upper_bounded(2.0)}
    return (CoordinateTransform(table, dim=dim),
            J.CoordinateTransform(jtable, dim=dim))


def test_coordinate_transform_maps_match_jax():
    tf, jtf = _mixed()
    y = (3.0 * np.random.default_rng(0).standard_normal((64, 6))).astype(
        np.float32)
    yt = torch.from_numpy(y)
    with jax.enable_x64(False):
        jy = jnp.asarray(y)
        want = {"to_x": jtf.to_x(jy), "log_det": jtf.log_det(jy),
                "_dx_dy": jtf._dx_dy(jy), "_dlogdet_dy": jtf._dlogdet_dy(jy)}
        x = np.array(want["to_x"])
        want["to_y"] = jtf.to_y(jnp.asarray(x))
    for key, w in want.items():
        arg = torch.from_numpy(x) if key == "to_y" else yt
        got = getattr(tf, key)(arg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    # identity coordinates pass through untouched
    np.testing.assert_array_equal(_np(tf.to_x(yt))[:, [1, 5]], y[:, [1, 5]])
    # a [K, C, D] stack maps row by row
    stack = torch.stack([yt, 2 * yt])
    torch.testing.assert_close(tf.to_x(stack)[1], tf.to_x(2 * yt))
    assert "interval(0, 1)" in repr(tf) and tf.dim == 6
    assert tf.cuda_form[:3] == ((T.BIJ_POSITIVE, 0.0, 1.0),
                                identity().cuda,
                                (T.BIJ_INTERVAL, 0.0, 1.0))
    with pytest.raises(ValueError, match="dim is required"):
        CoordinateTransform({0: positive()})
    with pytest.raises(ValueError, match="out of range"):
        CoordinateTransform({5: positive()}, dim=3)
    with pytest.raises(ValueError, match="got 2 bijectors"):
        CoordinateTransform([positive(), identity()], dim=3)
    # exact boundary values snap just inside the range
    edge = tf.to_y(torch.tensor([[0.0, 0.0, 1.0, -1.0, 2.0, 0.0]]))
    assert torch.isfinite(edge).all()


def test_builtin_bijectors_group_into_one_masked_pass():
    # tests/test_transforms.py:425-447
    d = 10_000
    tf = CoordinateTransform({i: positive() for i in range(d)}, dim=d)
    assert len(tf._groups) == 1
    mixed = CoordinateTransform(
        {0: positive(), 1: interval(0.0, 1.0), 2: interval(0.0, 1.0),
         3: positive(), 4: lower_bounded(2.0), 5: lower_bounded(2.0)},
        dim=8)
    assert len(mixed._groups) == 3
    two = CoordinateTransform({0: interval(0.0, 1.0),
                               1: interval(0.0, 2.0)}, dim=2)
    assert len(two._groups) == 2

    def mk():
        return Bijector(torch.exp, torch.log, lambda y: y)

    a, b = mk(), mk()
    custom = CoordinateTransform({0: a, 1: a, 2: b}, dim=3)
    assert len(custom._groups) == 2 and custom.cuda_form is None
    # the all-positive stack maps in one pass with no select
    y = torch.randn(4, d)
    torch.testing.assert_close(tf.to_x(y), torch.exp(y))


def _scale_location():
    """x0 > 0 a scale, x1 | x0 ~ N(0, x0^2), x0 ~ Exp(1)
    (tests/test_transforms.py:291-301)."""

    def logp(x):
        return -x[..., 0] - 0.5 * (x[..., 1] / x[..., 0]) ** 2 - torch.log(
            x[..., 0])

    return Target(logp=logp)


def _natural_init(n):
    x0 = mt.init_det(n, 2, **CPU)
    x0[:, 0] = torch.exp(0.3 * x0[:, 0])
    return x0


def test_out_of_range_natural_inits_raise():
    # tests/test_transforms.py:393-424: named by chain and coordinate
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(8)
    x0[2, 0] = -1.0
    for make in (lambda: mt.HMC(_scale_location(), x0, 0.05, 3,
                                transform=tf, **CPU),
                 lambda: mt.NUTS(_scale_location(), x0, 0.8, transform=tf,
                                 **CPU)):
        with pytest.raises(ValueError,
                           match=r"non-finite.*chain 2, coordinate 0: "
                                 r"positive"):
            make()
    tfi = CoordinateTransform({1: interval(0.0, 1.0)}, dim=2)
    xb = _natural_init(8)
    xb[:, 1] = 0.5
    xb[1, 1] = 1.5
    with pytest.raises(ValueError, match=r"chain 1, coordinate 1: interval"):
        mt.MetropolisHastings(_scale_location(),
                              isotropic_gaussian_proposal(0.5), xb,
                              transform=tfi, **CPU)
    with pytest.raises(ValueError, match="D=3 transform"):
        mt.HMC(_scale_location(), _natural_init(8), 0.05, 3,
               transform=CoordinateTransform({0: positive()}, dim=3), **CPU)


def _wrapped_cases(case):
    """(port wrapped, JAX wrapped, y [C, D] float32) of each case."""
    g = np.random.default_rng({"rosenbrock": 1, "gauss2d": 2,
                               "normal512": 3}[case])
    if case == "rosenbrock":
        table = {0: (positive(), J.positive()),
                 2: (interval(-2.0, 3.0), J.interval(-2.0, 3.0))}
        t, jt, d = mt.rosenbrock_nd(), jm.rosenbrock_nd(), 3
    elif case == "gauss2d":
        table = {0: (positive(), J.positive()),
                 1: (upper_bounded(4.0), J.upper_bounded(4.0))}
        t, jt, d = (mt.diffable_gaussian2d(MEAN, COV),
                    jm.diffable_gaussian2d(MEAN, COV), 2)
    else:
        d = 512
        kinds = [(identity(), J.identity()), (positive(), J.positive()),
                 (lower_bounded(-1.0), J.lower_bounded(-1.0)),
                 (upper_bounded(2.0), J.upper_bounded(2.0)),
                 (interval(0.0, 1.0), J.interval(0.0, 1.0))]
        table = {i: kinds[i * 5 // d] for i in range(d)}
        t, jt = mt.standard_normal(), jm.standard_normal()
    tf = CoordinateTransform({i: p for i, (p, _) in table.items()}, dim=d)
    jtf = J.CoordinateTransform({i: q for i, (_, q) in table.items()},
                                dim=d)
    y = (1.5 * g.standard_normal((32, d))).astype(np.float32)
    return tf.wrap(t), jtf.wrap(jt), y


def _row_close(got, want, rtol=1e-5):
    """Per row, within rtol of each entry plus rtol of the row's largest
    entry (a Rosenbrock gradient cancels near a component's zero)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want) - rtol * (np.abs(want) + scale)
    assert (err <= 0).all(), float(err.max())


@pytest.mark.parametrize("case", ["rosenbrock", "gauss2d", "normal512"])
def test_wrap_matches_jax(case):
    w, jw, y = _wrapped_cases(case)
    yt = torch.from_numpy(y)
    with jax.enable_x64(False):
        jy = jnp.asarray(y)
        jlp, jg = jw.batch_logp_and_grad(jy)
        want = {"logp_batch": np.asarray(jw.batch_logp(jy)),
                "logp": np.asarray(jax.vmap(jw.logp)(jy[:4])),
                "grad": np.asarray(jg)}
        if jw.logp_normalized is not None:
            want["logp_normalized"] = np.asarray(
                jax.vmap(jw.logp_normalized)(jy))
        jfn, jtabs = jw.sep_forms()
        jtabs = [jnp.asarray(t, jnp.float32).reshape(1, -1) for t in jtabs]
        lo, hi = y.shape[1] // 3, y.shape[1]
        want["sep_form"] = np.asarray(jfn(jy[:, lo:hi],
                                          *[t[:, lo:hi] for t in jtabs]))
    lp, g = w.batch_logp_and_grad(yt)
    got = {"logp_batch": w.batch_logp(yt), "logp": w.logp(yt[:4]),
           "grad": g}
    if w.logp_normalized is not None:
        got["logp_normalized"] = w.logp_normalized(yt)
    fn, tabs = w.sep_forms()
    tabs = [t.float() for t in tabs]
    assert len(tabs) == len(jtabs)
    got["sep_form"] = fn(yt[:, lo:hi], *[t[:, lo:hi] for t in tabs])
    assert set(got) == set(want)
    for key in want:
        if key == "grad":
            _row_close(got[key], want[key])
        else:
            np.testing.assert_allclose(_np(got[key]), want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    torch.testing.assert_close(lp, got["logp_batch"])
    if case == "normal512":  # separable: validated as the tier does
        mt.models.validate_separable(w, yt)


def _gauss_wrapped():
    tf = CoordinateTransform({0: positive()}, dim=2)
    jtf = J.CoordinateTransform({0: J.positive()}, dim=2)
    return (tf, tf.wrap(mt.diffable_gaussian2d(MEAN, COV)),
            jtf.wrap(jm.diffable_gaussian2d(MEAN, COV)))


@pytest.mark.parametrize("case", ["gauss2d", "rosenbrock"])
def test_leapfrog_twin_on_transformed_target_matches_jax_pallas(case):
    # Kernel 1's twin against the Pallas trajectory on JAX's wrapped
    # chains-on-lanes forms, the same momenta
    w, jw, y = _wrapped_cases(case)
    g = np.random.default_rng(9)
    y = (0.5 * y).astype(np.float32)
    mom = g.standard_normal(y.shape).astype(np.float32)
    eps, n_leapfrog = (0.2, 8) if case == "gauss2d" else (0.01, 8)
    with jax.enable_x64(False):
        _, jgrad = jw.batch_logp_and_grad(jnp.asarray(y))
        traj = make_pallas_leapfrog(jw.grad_dc, jw.logp_dc, eps, n_leapfrog,
                                    interpret=True)
        want = [np.asarray(v) for v in traj(jnp.asarray(y), jnp.asarray(mom),
                                            jgrad, jnp.float32(eps))]
    launches = leapfrog_trajectory.launches
    got = leapfrog_trajectory(w, torch.from_numpy(y), torch.from_numpy(mom),
                              torch.from_numpy(np.array(jgrad)),
                              torch.tensor(eps), n_leapfrog)
    assert leapfrog_trajectory.launches == launches  # CPU: the twin
    for a, b in zip(got, want):
        _row_close(a if a.dim() > 1 else a[:, None],
                   b if b.ndim > 1 else b[:, None])


def test_subtree_twin_on_transformed_target_matches_jax_pallas():
    c, j = 1024, 4  # one JAX grid block: its lane id is the chain index
    _, w, jw = _gauss_wrapped()
    g = np.random.default_rng(11)
    y = g.standard_normal((c, 2)).astype(np.float32)
    mom = g.standard_normal((c, 2)).astype(np.float32)
    lp, grad = w.batch_logp_and_grad(torch.from_numpy(y))
    joint0 = (_np(lp) - 0.5 * (mom * mom).sum(1)).astype(np.float32)
    logu = (joint0 - g.exponential(size=c)).astype(np.float32)
    v = np.where(g.uniform(size=c) < 0.5, -1, 1).astype(np.int32)
    eps = g.uniform(0.2, 0.8, size=c).astype(np.float32)
    active = g.uniform(size=c) < 0.75
    seed = (424242, -13579)
    with jax.enable_x64(False):
        fn = make_pallas_subtree(jw.grad_dc, jw.logp_dc, 10, interpret=True)
        want = [np.asarray(x) for x in fn(
            jnp.asarray(y), jnp.asarray(mom), jnp.asarray(_np(grad)),
            jnp.asarray(logu), jnp.asarray(v), jnp.int32(j),
            jnp.asarray(eps), jnp.asarray(joint0), jnp.asarray(active),
            jnp.asarray(seed, jnp.int32))]
    calls = subtree_plain.calls
    got = subtree(w, torch.from_numpy(y), torch.from_numpy(mom),
                  grad.contiguous(), torch.from_numpy(logu),
                  torch.from_numpy(v), j, torch.from_numpy(eps),
                  torch.from_numpy(joint0), torch.from_numpy(active), seed,
                  10)
    assert subtree_plain.calls == calls + 1
    got = [_np(x) for x in got]
    # per chain, as tests/test_torch_nuts_kernels.py: counts and flags, and
    # the floats where the subtree continues
    same = np.ones(c, bool)
    for k in (6, 7, 9, 10):  # n, s, n_alpha, diverged
        same &= got[k] == want[k]
    same &= np.isclose(got[8], want[8], rtol=1e-5, atol=1e-6)  # alpha
    s = want[7].astype(bool)
    for a, b in zip(got[:6], want[:6]):
        ok = np.isclose(a, b, rtol=1e-5, atol=1e-5).reshape(c, -1).all(1)
        same &= ok | ~s
    assert same.mean() >= 0.999, same.mean()
    assert s.any() and (~s).any()


def _sep_case(scaled: bool):
    """A D=40 standard normal under a mixed table (five blocks: identity,
    positive, lower(-1), upper(2), interval(0, 1)), optionally whitened by
    a diagonal metric, in both packages."""
    d = 40
    kinds = [(identity(), J.identity()), (positive(), J.positive()),
             (lower_bounded(-1.0), J.lower_bounded(-1.0)),
             (upper_bounded(2.0), J.upper_bounded(2.0)),
             (interval(0.0, 1.0), J.interval(0.0, 1.0))]
    table = {i: kinds[i * 5 // d] for i in range(d)}
    tf = CoordinateTransform({i: p for i, (p, _) in table.items()}, dim=d)
    jtf = J.CoordinateTransform({i: q for i, (_, q) in table.items()},
                                dim=d)
    w, jw = tf.wrap(mt.standard_normal()), jtf.wrap(jm.standard_normal())
    if scaled:
        scale = (0.3 + np.random.default_rng(7).random(d)).astype(
            np.float32)
        w = precondition_target(w, Preconditioner(
            "diag", scale=torch.from_numpy(scale)))
        jw = jm.precondition_target(jw, jm.Preconditioner(
            "diag", scale=jnp.asarray(scale)))
    return w, jw, d


@pytest.mark.parametrize("scaled", [False, True])
def test_separable_twin_on_transformed_target_matches_jax_pallas(scaled):
    """Kernel 7's twin on the transformed sep_form (one mask table per
    bijector group, then the scale under a metric) against
    ``make_pallas_hmc_separable(interpret=True, mom_input=True)`` on JAX's,
    C=8, D=40 over [4, 10] JAX tiles."""
    w, jw, d = _sep_case(scaled)
    g = np.random.RandomState(12 + scaled)
    c, n_leapfrog, eps = 8, 6, 0.1
    pos = (0.5 * g.randn(c, d)).astype(np.float32)
    mom = g.randn(c, d).astype(np.float32)
    fn, tabs = jw.sep_forms()
    traj = make_pallas_hmc_separable(fn, n_leapfrog, n_tables=len(tabs),
                                     interpret=True, mom_input=True,
                                     block_c=4, block_d=10)
    jtabs = tuple(jnp.asarray(t, jnp.float32).reshape(1, -1) for t in tabs)
    with jax.enable_x64(False):
        pos_j, mom_j, pe, ke0, ke1 = (np.asarray(a) for a in traj(
            jnp.asarray(pos), jnp.asarray(mom), eps, *jtabs))
    fid, n_rows, flags = sep_instance(w)
    assert (fid, flags) == (0, 2 | scaled) and n_rows == len(tabs) == (
        4 + scaled)  # four non-identity groups
    assert sep_functor(w) == (0, n_rows)
    tables = torch.cat([t.float() for t in w.sep_forms()[1]])
    calls = hmc_separable_plain.calls
    pos_t, logp_t, ke0_t, ke1_t, mom_t = hmc_separable(
        w, torch.from_numpy(pos), torch.tensor([eps]), n_leapfrog, 0, 0,
        tables, torch.from_numpy(mom))
    assert hmc_separable_plain.calls == calls + 1
    for got, want in ((pos_t, pos_j), (mom_t, mom_j),
                      (logp_t, pe.sum(1)), (ke0_t, ke0.sum(1)),
                      (ke1_t, ke1.sum(1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cuda_description_of_wrapped_targets():
    """What the kernels read: the bijector table ahead of the functor's
    coefficients at D <= 4 (after L's triangle under a metric), none above
    it; the instance bits; the targets they refuse, by name."""
    head = T.soft_saturation_constants()
    assert len(head) == _build.TRANSFORM_HEAD
    np.testing.assert_allclose(head, [39.925278, 39.925278, 1 / 39.925278,
                                      7.9711924, 7.9711924, 1 / 7.9711924],
                               rtol=1e-6)
    tf, w, _ = _gauss_wrapped()
    g2 = mt.diffable_gaussian2d(MEAN, COV)
    table = head + (1.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    assert w.cuda_transform == ((1, 0.0, 1.0), (0, 0.0, 0.0))
    assert w.cuda_params == table + g2.cuda_params
    assert _build.instance_flags(w) == 2 and _build.functor_id(w) == 1
    assert _build.instance_flags(g2) == 0
    # a metric over the transform: L's triangle first, then the table
    pre = Preconditioner("diag", scale=torch.tensor([2.0, 0.5]))
    ww = precondition_target(w, pre)
    assert ww.cuda_params == (2.0, 0.0, 0.5) + table + g2.cuda_params
    assert _build.instance_flags(ww) == 3 and ww.cuda_scaled
    # two metrics merge their Ls outside the transform, keeping the table
    www = precondition_target(ww, pre)
    assert www.cuda_params == (4.0, 0.0, 0.25) + table + g2.cuda_params
    assert www.cuda_transform == w.cuda_transform
    # the functor alone (Kernel 7) reads past both
    big = mt.models.isotropic_gaussian_target(2.0)
    wb = CoordinateTransform({0: positive()}, dim=3).wrap(big)
    assert len(wb.cuda_params) == len(head) + 9 + 1
    assert _build.params_ptr(wb, "cpu", 3) == _build.params_ptr(big, "cpu")
    # above D = 4 no table in cuda_params: the separable kernel reads its
    # own; the transform of 10,000 coordinates builds in well under a second
    import time

    t0 = time.perf_counter()
    tfd = CoordinateTransform({i: positive() for i in range(10_000)},
                              dim=10_000)
    wd = tfd.wrap(mt.standard_normal())
    assert time.perf_counter() - t0 < 1.0
    assert wd.cuda_params == () and len(wd.cuda_transform) == 10_000
    assert sep_instance(wd) == (0, 1, 2)
    # the kernels refuse, by name: a custom bijector, a transform around a
    # whitened or a transformed target; MH and tempering a whitened one
    custom = CoordinateTransform({0: Bijector(torch.exp, torch.log,
                                              lambda y: y, "mine")}, dim=2)
    wc = custom.wrap(g2)
    assert wc.cuda_transform is None and "custom Bijector" in (
        wc.cuda_unsupported)
    for bad, why in ((wc, "custom Bijector"),
                     (tf.wrap(precondition_target(g2, pre)), "whitened"),
                     (tf.wrap(w), "transformed target"),
                     (precondition_target(wc, pre), "custom")):
        assert bad.cuda_transform is None
        for check in (_build.functor_id, _build.instance_flags):
            with pytest.raises(ValueError, match=why):
                check(bad)
    with pytest.raises(ValueError, match="custom"):
        sep_instance(custom.wrap(mt.standard_normal()))
    assert _build.unwhitened(w, "the MH kernel") is True
    assert _build.unwhitened(g2, "the MH kernel") is False
    with pytest.raises(ValueError, match="whitened"):
        _build.unwhitened(precondition_target(g2, pre), "the MH kernel")


@pytest.mark.parametrize("d", [2, 3, 4, 5])
def test_neal_funnel_matches_jax(d):
    t, jt = mt.neal_funnel(3.0), jm.neal_funnel(3.0)
    x = (1.5 * np.random.default_rng(d).standard_normal((64, d))).astype(
        np.float32)
    xt = torch.from_numpy(x)
    with jax.enable_x64(False):
        jx = jnp.asarray(x)
        want_lp = np.asarray(jax.vmap(jt.logp)(jx))
        want_g = np.asarray(jax.vmap(jt.grad)(jx))
        want_batch = np.asarray(jt.logp_batch(jx))
        want_dc = np.asarray(jt.logp_dc(jx.T))
    np.testing.assert_allclose(_np(t.logp(xt)), want_lp, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(t.batch_logp(xt)), want_batch, rtol=1e-5,
                               atol=1e-5)
    _row_close(t.batch_grad(xt), want_g)
    if d in _build.KERNEL_DIMS:
        # the NealFunnel functor's plain version against JAX's logp_dc
        np.testing.assert_allclose(_np(t.batch_logp(xt)), want_dc,
                                   rtol=1e-5, atol=1e-5)
    assert t.cuda_functor == "neal_funnel" and _build.functor_id(t) == 4
    assert t.cuda_params == (1.0 / 9.0,)


def test_convert_carries_a_jax_transform():
    table = {0: J.positive(), 1: J.interval(0.1, 0.3)}
    jtf = J.CoordinateTransform(table, dim=2)
    jt = jm.diffable_gaussian2d(MEAN, COV)
    x0 = np.array(jtf.to_x(jnp.asarray(np.random.default_rng(0)
                                        .standard_normal((8, 2)))))
    jh = JaxHMC(jt, x0, 0.1, 4, transform=jtf)
    kw = sampler_kwargs(jh)
    tf = kw["transform"]
    assert isinstance(tf, CoordinateTransform)
    assert [b.name for b in tf._table] == ["positive", "interval(0.1, 0.3)"]
    assert tf._table[1].cuda == (T.BIJ_INTERVAL, 0.1, 0.3 - 0.1)
    h = mt.HMC(mt.diffable_gaussian2d(MEAN, COV), x0, **kw, **CPU)
    y = np.random.default_rng(1).standard_normal((16, 2)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jtf.wrap(jt).batch_logp(jnp.asarray(y)))
    np.testing.assert_allclose(_np(h.kernel_target.batch_logp(
        torch.from_numpy(y))), want, rtol=1e-5, atol=1e-5)
    # NUTS, MH and tempering carry it too; lower and upper bounds exactly
    jtf2 = J.CoordinateTransform({0: J.lower_bounded(-0.3),
                                  1: J.upper_bounded(7.25)}, dim=2)
    x2 = np.abs(x0) * np.array([1.0, -1.0], np.float32)
    for jax_sampler, conv in (
            (JaxNUTS(jt, x2, transform=jtf2), nuts_sampler_kwargs),
            (JaxMH(jt, jm.isotropic_gaussian_proposal(0.5), x2,
                   transform=jtf2), mh_sampler_kwargs),
            (JaxPT(jt, x2, betas=(1.0, 0.5), transform=jtf2),
             pt_sampler_kwargs)):
        got = conv(jax_sampler)["transform"]
        assert [b.cuda for b in got._table] == [(T.BIJ_LOWER, -0.3, 1.0),
                                               (T.BIJ_UPPER, 7.25, -1.0)]
    # one port bijector per distinct JAX one: the same grouping
    shared = J.CoordinateTransform({0: J.positive(), 2: J.positive()}, dim=3)
    assert len(transform_from_jax(shared)._groups) == 1
    custom = J.CoordinateTransform(
        {0: J.Bijector(jnp.exp, jnp.log, lambda y: y, "positive")}, dim=2)
    with pytest.raises(ValueError, match="custom Bijector"):
        transform_from_jax(custom)
    with pytest.raises(ValueError, match="transform"):
        sampler_kwargs(SimpleNamespace(_ctor=dict(transform=object()),
                                       metric=None))


def test_transformed_target_returns_both():
    w, tf = transformed_target(mt.standard_normal(), [positive()])
    assert isinstance(tf, CoordinateTransform) and tf.dim == 1
    y = torch.tensor([[0.7]])
    torch.testing.assert_close(w.logp(y), -0.5 * torch.exp(y[:, 0]) ** 2
                               + y[:, 0])
    ident, tfi = transformed_target(mt.standard_normal(), {}, dim=3)
    assert tfi.is_identity and ident.cuda_functor == "standard_normal"
