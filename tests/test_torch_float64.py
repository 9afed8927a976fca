"""Float64 states in the port, the twin of tests/test_float64.py.

The JAX package's kernels are dtype-generic over the initial positions'
dtype, and Kernel 1 (``ops/pallas/hmc.py:make_pallas_leapfrog``) is the one
fused kernel that runs float64 under ``jax_enable_x64``; the port gives
Kernel 1 float64 instances and keeps float32 for the others. Here, on the
CPU, the samplers of tests/test_float64.py run at float64 on their plain
tiers and on the ``use_pallas=True`` twin of Kernel 1, with that test's
dtype and moment asserts; Kernel 1's plain twin at float64 is held against
the Pallas kernel in interpret mode at float64 on the same numpy inputs,
for the built-in densities, both metrics, a transform and a user density;
and the float64 instance of a user density (its C++ read at double) is
built for the host with ``g++`` and held against its batch form.
``tests/conftest.py`` turns on ``jax_enable_x64``, so the JAX side runs
in this process.

Tolerance: 1e-10 relative (to each row's largest entry) at L = 8 for the
twin against the Pallas kernel: both run the same float64 arithmetic in
another order (XLA fuses and contracts; PyTorch does neither), which moves
a short stable trajectory by some 1e-15 relative; 1e-12 for the host
build's density and gradient against the batch form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import (
    Preconditioner,
    Target,
    precondition_target,
)
from mini_mcmc_torch.models.transforms import soft_saturation_constants
from mini_mcmc_torch.ops.adapt import dual_average_step_size
from mini_mcmc_torch.ops.kernels import (
    _build,
    gibbs_full,
    hmc,
    hmc_full,
    hmc_sep,
    mh_full,
    nuts_full,
    nuts_subtree,
    pt_full,
    user_density,
)
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.sgmcmc import target_grad
from mini_mcmc_torch.runner import StepKey
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models import transforms as J
from mini_mcmc_tpu.models.base import Target as JaxTarget
from mini_mcmc_tpu.models.precondition import Preconditioner as JaxPre
from mini_mcmc_tpu.ops.pallas.hmc import make_pallas_leapfrog

torch.set_num_threads(1)

CPU = dict(device="cpu")
F64 = torch.float64
RTOL = 1e-10
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _init(c, d):
    return mt.init_det(c, d, dtype=F64, **CPU)


def _row_close(got, want, rtol):
    """Per row, within ``rtol`` of the row's largest |entry| (a
    Rosenbrock gradient cancels near a component's zero)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-300)
    err = np.abs(got - want) / scale
    assert np.isfinite(got).all() and (err <= rtol).all(), float(err.max())


# -- tests/test_float64.py's samplers, in the port, at float64 ------------


def test_float64_mh():
    t = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    for use_pallas in (False, "full"):  # "full" on the CPU: Kernel 5's twin
        mh = mt.MetropolisHastings(
            t, mt.isotropic_gaussian_proposal(1.0), _init(4, 2),
            use_pallas=use_pallas, **CPU).seed(42)
        s = mh.run(500, 100)
        assert s.dtype == F64 and mh.state.positions.dtype == F64
        assert abs(float(s.mean())) < 0.3


@pytest.mark.parametrize("use_pallas", [False, True])
def test_float64_hmc(use_pallas):
    # True: Kernel 1's twin, the tier whose kernel takes float64 on CUDA
    h = mt.HMC(mt.rosenbrock_nd(), _init(4, 3), 0.05, 8,
               use_pallas=use_pallas, **CPU).seed(1)
    sh = h.run(200, 100)
    assert sh.dtype == F64
    assert h.state.logp.dtype == F64 and h.state.grad.dtype == F64
    rhat, _ = mt.split_rhat_mean_ess(sh)
    assert bool(torch.isfinite(rhat).all())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_float64_mala_tuned(use_pallas):
    # the dual-averaging tuner carries float64 scalars for a float64 state
    ml = mt.MALA(mt.rosenbrock_nd(), _init(4, 3), step_size=0.5,
                 use_pallas=use_pallas, **CPU).seed(4).tuned(100)
    sm = ml.run(200, 50)
    assert sm.dtype == F64
    assert np.isfinite(float(sm.mean()))


def test_float64_slice_and_elliptical():
    t = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    s2 = mt.SliceSampler(t, _init(4, 2), **CPU).seed(2).run(300, 50)
    assert s2.dtype == F64
    assert abs(float(s2.mean())) < 0.3
    lik = Target(logp=lambda x: -0.5 * torch.sum((x - 1.0) ** 2, dim=-1))
    s3 = mt.EllipticalSliceSampler(lik, _init(4, 2), **CPU).seed(3).run(
        300, 50)
    assert s3.dtype == F64
    assert abs(float(s3.mean()) - 0.5) < 0.25


def _within_se(s, truth, n_se=5.0):
    """|mean - truth| within ``n_se`` standard errors of the mean, the SE
    from the spread of the per-chain means (independent chains)."""
    chain = s.reshape(s.shape[0], -1).mean(dim=1)
    se = float(chain.std()) / chain.numel() ** 0.5
    return abs(float(s.mean()) - truth) <= n_se * se


def test_float64_sgld_and_sghmc():
    # 256 chains where tests/test_float64.py starts 4: SGLD's decaying
    # step mixes over ~250 steps, so at 4 chains its mean gate fails on
    # ~27% of seeds of the port's streams (a 30-seed sweep); the gates
    # also hold the mean within 5 standard errors at 256 chains
    t = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    g = target_grad(t)
    s4 = mt.SGLD(g, _init(256, 2),
                 step_size=mt.polynomial_decay(5e-2, 10.0, 0.55),
                 **CPU).seed(5).run(300, 100)
    assert s4.dtype == F64
    assert abs(float(s4.mean())) < 0.3 and _within_se(s4, 0.0)
    s5 = mt.SGHMC(g, _init(256, 2), step_size=0.05, friction=0.1,
                  **CPU).seed(6).run(300, 100)
    assert s5.dtype == F64
    assert abs(float(s5.mean())) < 0.35 and _within_se(s5, 0.0)


def test_dual_averaging_iterate_follows_a_float64_state():
    seen = []

    def step_eps(state, key, eps):
        seen.append(eps.dtype)
        return state, torch.tensor(0.7, dtype=eps.dtype)

    for dtype in (torch.float32, F64):
        state = mt.ops.hmc.HMCState(torch.zeros((4, 2), dtype=dtype),
                                    None, None)
        _, eps, alphas = dual_average_step_size(
            step_eps, state, StepKey(torch.Generator(), 0, 0), 5, 0.1, 0.65)
        want = F64 if dtype == F64 else torch.float32
        assert set(seen[-5:]) == {want} and alphas.dtype == want
        assert isinstance(eps, float)


# -- Kernel 1's twin at float64 against the Pallas kernel ------------------


def _jax_user_rosenbrock():
    r = jm.rosenbrock_nd()
    return JaxTarget(logp=r.logp)


def _cases():
    """name -> (port target, JAX (grad_dc, logp_dc), D, eps, y scale,
    shift): Kernel 1's instances at float64."""
    def jforms(jt):
        logp_dc, grad_dc = jt.dc_forms()
        return grad_dc, logp_dc

    diag = np.random.default_rng(4).uniform(0.5, 2.0, 3)
    a = np.random.default_rng(5).standard_normal((3, 3))
    chol = np.linalg.cholesky(a @ a.T / 3 + np.eye(3))
    pos0 = {0: (mt.positive(), J.positive())}
    return {
        "rosenbrock3": (mt.rosenbrock_nd(), jforms(jm.rosenbrock_nd()), 3,
                        0.02, 0.3, 0.8),
        "gaussian2d": (mt.diffable_gaussian2d(MEAN, COV),
                       jforms(jm.diffable_gaussian2d(MEAN, COV)), 2, 0.3,
                       1.5, 0.0),
        "funnel4": (mt.neal_funnel(3.0), jforms(jm.neal_funnel(3.0)), 4,
                    0.1, 0.8, 0.0),
        "diag_rosenbrock3": (
            precondition_target(mt.rosenbrock_nd(), Preconditioner(
                "diag", scale=torch.from_numpy(diag))),
            jforms(jm.precondition_target(jm.rosenbrock_nd(), JaxPre(
                "diag", scale=jnp.asarray(diag)))), 3, 0.01, 0.3, 0.5),
        "dense_rosenbrock3": (
            precondition_target(mt.rosenbrock_nd(), Preconditioner(
                "dense", chol=torch.from_numpy(chol))),
            jforms(jm.precondition_target(jm.rosenbrock_nd(), JaxPre(
                "dense", chol=jnp.asarray(chol)))), 3, 0.005, 0.3, 0.3),
        "positive_gaussian2d": (
            mt.CoordinateTransform({0: pos0[0][0]}, dim=2).wrap(
                mt.diffable_gaussian2d(MEAN, COV)),
            jforms(J.CoordinateTransform({0: pos0[0][1]}, dim=2).wrap(
                jm.diffable_gaussian2d(MEAN, COV))), 2, 0.2, 0.7, 0.0),
        "user_rosenbrock5": (F.rosenbrock_user(hand=False),
                             jforms(_jax_user_rosenbrock()), 5, 0.01, 0.3,
                             0.8),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_leapfrog_twin_float64_matches_jax_pallas(case):
    t, (grad_dc, logp_dc), d, eps, scale, shift = _cases()[case]
    g = np.random.default_rng(list(_cases()).index(case))
    y = g.standard_normal((64, d)) * scale + shift
    mom = g.standard_normal((64, d))
    n_leapfrog = 8
    jy, jmom = jnp.asarray(y, jnp.float64), jnp.asarray(mom, jnp.float64)
    jgrad = jnp.asarray(grad_dc(jy.T)).T
    traj = make_pallas_leapfrog(grad_dc, logp_dc, eps, n_leapfrog,
                                interpret=True)
    want = [np.asarray(v) for v in traj(jy, jmom, jgrad, jnp.float64(eps))]
    assert all(w.dtype == np.float64 for w in want)
    launches = leapfrog_trajectory.launches
    got = leapfrog_trajectory(t, torch.from_numpy(y), torch.from_numpy(mom),
                              torch.from_numpy(np.array(jgrad)),
                              torch.tensor(eps, dtype=F64), n_leapfrog)
    assert leapfrog_trajectory.launches == launches  # CPU: the twin
    for a, b in zip(got, want):
        assert a.dtype == F64
        _row_close(a.numpy(), b, RTOL)
    # the twin's own start: the batch form's gradient at float64
    _, g0 = t.batch_logp_and_grad(torch.from_numpy(y))
    _row_close(g0.numpy(), np.asarray(jgrad), RTOL)


def test_leapfrog_twin_float64_is_the_float64_trajectory():
    """The float64 twin is not a float32 trajectory cast: it differs from
    the float32 twin by far more than float64 rounding."""
    t = mt.rosenbrock_nd()
    x = _init(16, 3) * 0.3 + 0.8
    mom = torch.randn(x.shape, generator=torch.Generator().manual_seed(1),
                      dtype=F64)
    eps = torch.tensor(0.02, dtype=F64)
    _, g = t.batch_logp_and_grad(x)
    p64 = leapfrog_trajectory_plain(t, x, mom, g, eps, 32)
    p32 = leapfrog_trajectory_plain(t, x.float(), mom.float(), g.float(),
                                    eps.float(), 32)
    assert all(a.dtype == F64 for a in p64)
    assert float((p64[0] - p32[0].double()).abs().max()) > 1e-9


# -- the float64 instance of a user density, built for the host ------------


@pytest.mark.parametrize("hand", [True, False])
@pytest.mark.parametrize("wrap", ["plain", "diag", "positive"])
def test_user_density_float64_host_build_matches_batch_form(hand, wrap):
    t = F.rosenbrock_user(hand)
    if wrap == "diag":
        t = precondition_target(t, Preconditioner(
            "diag", scale=torch.linspace(0.5, 1.5, 5, dtype=F64)))
    elif wrap == "positive":
        t = mt.CoordinateTransform({0: mt.positive()}, dim=5).wrap(t)
    y = torch.randn((64, 5), generator=torch.Generator().manual_seed(2),
                    dtype=F64) * 0.3 + 0.5
    lp, g = user_density.probe(t, y)  # the double instance, host build
    want_lp, want_g = t.batch_logp_and_grad(y)
    assert lp.dtype == F64 and g.dtype == F64
    _row_close(lp[:, None].numpy(), want_lp[:, None].numpy(), 1e-12)
    _row_close(g.numpy(), want_g.numpy(), 1e-12)
    mt.models.validate_dc_forms(t, y)  # the validator's float64 route


#: a user density that writes its shift as ``%s``: ``0.1`` is exact at
#: either scalar, ``0.1f`` leaves the double instance at float precision
SHIFTED_SOURCE = """
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S s = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const S d = x[i] - %s;
      s = s + d * d;
    }
    return -s / 2;
  }
};
"""


@pytest.mark.parametrize("literal", ["0.1", "0.1f"])
def test_float64_validation_catches_float_precision_sources(literal):
    """The float64 probe holds the double instance to F64_DC_TOL: a source
    whose ``f`` literal keeps it at float precision (~1e-8 off here) is
    refused at float64, where the JAX package's float32 tolerance would
    pass it, and still passes at float32."""
    t = Target(logp=lambda x: -0.5 * torch.sum((x - 0.1) ** 2, dim=-1),
               cuda_source=SHIFTED_SOURCE % literal)
    y = torch.randn((64, 5), generator=torch.Generator().manual_seed(2),
                    dtype=F64)
    mt.models.validate_dc_forms(t, y.float())
    mt.models.validate_dc_forms(t, y, rtol=3e-4, atol=1e-4)
    if literal == "0.1":
        mt.models.validate_dc_forms(t, y)
        return
    with pytest.raises(ValueError, match="f-suffixed literal"):
        mt.models.validate_dc_forms(t, y)


def test_float64_library_reads_the_source_at_double():
    spec, params = user_density.density_spec(F.rosenbrock_user(False), 5,
                                              dtype=F64)
    assert spec.types == ("double",)
    units = user_density.library_sources(*spec)
    assert list(units) == ["leapfrog"]  # Kernel 1 and the probe alone
    text = units["leapfrog"]
    assert user_density.F64_MATH in text and "mm_leapfrog_f64" in text
    assert "mm::UserS<mm_user::Density, double>" in text
    # the trace at float64: doubles, no float literal, no float keyword in
    # the pasted source
    src = user_density.derive_logp_dc(F.rosenbrock_user(False), 5,
                                      dtype=F64)[0]
    assert "const double* p_" in src and not any(
        tok.endswith("f") and tok.startswith("0x")
        for tok in src.replace("(", " ").replace(")", " ").split())
    # the float32 library is untouched by the float64 route
    f32, _ = user_density.density_spec(F.rosenbrock_user(False), 5)
    assert f32.types == () and "mm_leapfrog_f64" not in "".join(
        user_density.library_sources(*f32).values())
    assert user_density.as_double("const float* p; float x = 0.5f;") == (
        "const double* p; double x = 0.5f;")


def test_kernel_params_at_float64_carry_the_double_squashes():
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    w = tf.wrap(mt.diffable_gaussian2d(MEAN, COV))
    pre = Preconditioner("dense", chol=torch.tensor([[1.0, 0.0],
                                                     [0.5, 2.0]], dtype=F64))
    ww = precondition_target(w, pre)
    for t, off in ((w, 0), (ww, 3)):
        p32 = _build.kernel_params(t, 2)
        p64 = _build.kernel_params(t, 2, F64)
        assert p32 == tuple(t.cuda_params)
        assert p64[off:off + 6] == soft_saturation_constants(F64)
        assert p64[off + 6:] == p32[off + 6:] and p64[:off] == p32[:off]
        assert p64[off:off + 6] != p32[off:off + 6]


def test_tier_dtypes_name_what_each_tier_takes():
    ok = {
        "HMC/MALA use_pallas=True (Kernel 1)": (torch.float32, F64),
        'MetropolisHastings use_pallas="full" (Kernel 5)': (torch.float32,
                                                            torch.int32),
    }
    # one tier a kernel module, each its module's TIER
    tiers = [m.TIER for m in (hmc, hmc_full, nuts_subtree, nuts_full,
                              mh_full, gibbs_full, hmc_sep, pt_full)]
    assert sorted(tiers) == sorted(_build.TIER_DTYPES) and len(tiers) == 8
    for tier in _build.TIER_DTYPES:
        for dtype in (torch.float32, F64, torch.int32):
            if dtype in ok.get(tier, (torch.float32,)):
                _build.check_tier_dtype(tier, dtype)
                continue
            with pytest.raises(ValueError) as e:
                _build.check_tier_dtype(tier, dtype)
            msg = str(e.value)
            assert tier in msg and "use_pallas=False" in msg
            assert "HMC/MALA use_pallas=True (Kernel 1): float32, float64" \
                in msg and "ROADMAP" not in msg
