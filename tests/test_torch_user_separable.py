"""User coordinate functors in the separable kernel (Kernel 7):
``Target.cuda_coord_source`` and the ``Coord`` functor generated from a
target's tile form, behind ``csrc/user_density.cuh:UserCoord`` and the
metric and transform wrappers (``coord_targets.cuh:Scaled``,
``TransformedCoord``), built for the host with ``g++`` through
``csrc/host_shim.h`` (the text nvcc compiles), against the JAX package's
``sep_forms()`` tile density on single coordinates and ``jax.grad``.

Tolerance: rtol 3e-4 with atol 1e-4 x max(|want|, 1), the JAX package's
``validate_dc_forms`` rule (float32 on both sides; libm's ``expf``,
``log1pf`` and ``tanhf`` against XLA's by an ulp or two, and the
bijectors' saturation constants within a few ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import Preconditioner, Target, precondition_target
from mini_mcmc_torch.models import transforms as T
from mini_mcmc_torch.models.base import validate_coord_dc
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_torch.ops.kernels.hmc_sep import sep_instance
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models import transforms as J

RTOL, ATOL = 3e-4, 1e-4
D = 12
SCALES = np.linspace(0.5, 2.0, D).astype(np.float32)
MEANS = np.linspace(-1.0, 1.0, D).astype(np.float32)


def _logistic_tile(xp, x, s):
    z = xp.abs(x / s)
    return xp.sum(-z - 2.0 * xp.log1p(xp.exp(-z)) - xp.log(s), axis=-1)


def _gauss_tile(xp, x, m, s):
    z = (x - m) / s
    return xp.sum(-0.5 * z * z - xp.log(s), axis=-1)


def _normal_tile(xp, x):
    return xp.sum(-0.5 * x * x, axis=-1)


def _pair(case: str):
    """(port target, JAX target) of a test case."""
    if case == "normal":  # no table: the batch form at D = 1
        def logp(x):
            return _normal_tile(torch, x)

        return Target(logp=logp), jm.Target(
            logp=lambda x: _normal_tile(jnp, x))
    if case.startswith("logistic"):
        s = torch.from_numpy(SCALES)
        port = F.logistic(s, hand=case == "logistic_hand")
        return port, jm.Target(
            logp=lambda x: _logistic_tile(jnp, x, jnp.asarray(SCALES)),
            sep_form=(lambda x, s: _logistic_tile(jnp, x, s),
                      (jnp.asarray(SCALES),)))
    m, s = torch.from_numpy(MEANS), torch.from_numpy(SCALES)
    port = Target(logp=lambda x: _gauss_tile(torch, x, m, s),
                  sep_form=(lambda x, m, s: _gauss_tile(torch, x, m, s),
                            (m, s)))
    return port, jm.Target(
        logp=lambda x: _gauss_tile(jnp, x, jnp.asarray(MEANS),
                                   jnp.asarray(SCALES)),
        sep_form=(lambda x, m, s: _gauss_tile(jnp, x, m, s),
                  (jnp.asarray(MEANS), jnp.asarray(SCALES))))


def _jax_terms(jt, x):
    """Each coordinate's term of JAX's tile density and its jax.grad at
    the rows of ``x`` ``[R, D]``: ``tile_logp`` on ``[R, 1]`` slices with
    ``[1, 1]`` tables."""
    tile, tables = jt.sep_forms()
    lp, g = [], []
    for d in range(x.shape[1]):
        tabs = [t[:, d:d + 1] for t in tables]
        xd = jnp.asarray(x[:, d:d + 1])
        lp.append(np.asarray(tile(xd, *tabs)))
        g.append(np.asarray(jax.grad(
            lambda v: jnp.sum(tile(v, *tabs)))(xd))[:, 0])
    return np.stack(lp, 1), np.stack(g, 1)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _points(seed, scale=2.0):
    g = np.random.default_rng(seed)
    return (scale * g.standard_normal((32, D))).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "logistic_hand",
                                  "logistic_derived", "gauss2"])
def test_coordinate_functors_match_the_jax_tile_form(case):
    """0, 1 and 2 tables; the hand source's own grad and Dual<1>'s."""
    t, jt = _pair(case)
    x = _points(1)
    fid, n_tables, flags = sep_instance(t)
    assert fid == -1 and flags == 0
    assert n_tables == {"normal": 0, "gauss2": 2}.get(case, 1)
    lp, g = U.coord_probe(t, torch.from_numpy(x))
    want_lp, want_g = _jax_terms(jt, x)
    _close(lp, want_lp, "term")
    _close(g, want_g, "derivative")
    validate_coord_dc(t, torch.from_numpy(x))


def _transforms():
    bij = ([T.positive(), T.interval(-3.0, 4.0), T.identity()],
           [J.positive(), J.interval(-3.0, 4.0), J.identity()])
    return (T.CoordinateTransform({i: bij[0][i % 3] for i in range(D)},
                                  dim=D),
            J.CoordinateTransform({i: bij[1][i % 3] for i in range(D)},
                                  dim=D))


@pytest.mark.parametrize("case", ["normal", "logistic_hand",
                                  "logistic_derived"])
@pytest.mark.parametrize("wrap", ["metric", "transform", "both"])
def test_wrapped_instances_match_the_jax_composed_tile_forms(case, wrap):
    """Scaled<UserCoord> (a diagonal metric), TransformedCoord<UserCoord>
    (positive, interval and identity coordinates) and both, against the
    JAX package's composed sep_forms (models/precondition.py:246-263,
    models/transforms.py:408-438)."""
    t, jt = _pair(case)
    scale = np.linspace(2.0, 0.6, D).astype(np.float32)
    if wrap in ("transform", "both"):
        tf, jtf = _transforms()
        t, jt = tf.wrap(t), jtf.wrap(jt)
    if wrap in ("metric", "both"):
        t = precondition_target(t, Preconditioner(
            "diag", scale=torch.from_numpy(scale)))
        jt = jm.precondition_target(jt, jm.Preconditioner(
            "diag", scale=jnp.asarray(scale)))
    _, _, flags = sep_instance(t)
    assert flags == {"metric": 1, "transform": 2, "both": 3}[wrap]
    x = _points(2, scale=1.0)
    lp, g = U.coord_probe(t, torch.from_numpy(x))
    want_lp, want_g = _jax_terms(jt, x)
    _close(lp, want_lp, "term")
    _close(g, want_g, "derivative")
    validate_coord_dc(t, torch.from_numpy(x))


def test_the_tracer_reads_each_table_as_the_coordinates_entry():
    t, _ = _pair("gauss2")
    source, params = U.derive_coord_dc(t)
    assert "kTables = 2" in source and "t[0]" in source and "t[1]" in source
    assert params == ()
    forms = U.coord_forms(t, D)
    assert forms.traced and forms.n_tables == 2
    hand = F.logistic(torch.from_numpy(SCALES))
    assert U.coord_forms(hand, D) == U.CoordForms(
        F.LOGISTIC_COORD_SOURCE, (), 1, False)


def test_refusals_more_than_two_tables_and_wrong_sources():
    s = torch.ones(D)
    three = Target(logp=lambda x: -0.5 * torch.sum(x * x, -1),
                   sep_form=(lambda x, a, b, c: -0.5 * torch.sum(
                       x * x * a * b * c, -1), (s, s, s)))
    with pytest.raises(ValueError, match="at most 2"):
        sep_instance(three)
    with pytest.raises(ValueError, match="at most 2"):
        U.derive_coord_dc(three)
    two, _ = _pair("gauss2")
    scaled = precondition_target(two, Preconditioner("diag", scale=s))
    with pytest.raises(ValueError, match="at most 2"):
        U.sep_spec(scaled, 1, D)
    # a metric around a density source keeps no tile form to trace
    es = Target(logp=lambda x: -0.5 * torch.sum(x * x, -1),
                cuda_source="struct Density {};")
    with pytest.raises(ValueError, match="cuda_coord_source"):
        sep_instance(precondition_target(es, Preconditioner("diag",
                                                            scale=s)))
    x = torch.from_numpy(_points(3))
    sc = torch.from_numpy(SCALES)
    wrong = Target(logp=F.logistic(sc).logp, sep_form=F.logistic(sc).sep_form,
                   cuda_coord_source=F.LOGISTIC_COORD_SOURCE.replace(
                       "2.0f * mm::log1p", "1.9f * mm::log1p"))
    with pytest.raises(ValueError, match="coordinate term"):
        validate_coord_dc(wrong, x)
    bad_grad = Target(logp=F.logistic(sc).logp,
                      sep_form=F.logistic(sc).sep_form,
                      cuda_coord_source=F.LOGISTIC_COORD_SOURCE.replace(
                          "0.5f * x", "0.4f * x"))
    with pytest.raises(ValueError, match="coordinate derivative"):
        validate_coord_dc(bad_grad, x)


def test_separable_sampler_runs_a_user_functor_on_every_device_path():
    """On the CPU the tier runs its twin on the tile form whatever the
    functor; the logistic's z = x / s has variance pi^2 / 3."""
    sc = torch.from_numpy(np.linspace(0.5, 2.0, 64).astype(np.float32))
    h = mt.HMC(F.logistic(sc), mt.init_with_seed(256, 64, seed=2,
                                                 device="cpu"),
               0.3, 10, use_pallas="separable", device="cpu").seed(2)
    z = (h.run(128, 64) / sc).double()
    assert abs(float(z.var()) / (np.pi ** 2 / 3) - 1) <= 0.05
    assert abs(float(z.mean())) <= 0.05
