"""The metric (``models/precondition.py``) in the port against the JAX
package on the same numpy inputs, and ``metric=`` on HMC and NUTS through
the plain twins of Kernels 1-4 (``tests/test_precondition.py``'s cases).

Tolerances: the maps and the estimator in float32 against JAX pinned to
float32 (the suite enables x64): rtol 1e-6 (maps; atol 1e-7 for entries
that cancel near 0) and 1e-5 (the estimator's sums over 4,096 chains);
in float64 against JAX in x64: 1e-12 and 1e-10. The wrapped densities at
rtol 1e-5 (float32; the Rosenbrock gradient's atol scaled to the chain's
largest |g|, as tests/test_torch_models.py scales it). Kernel 1's twin
against ``make_pallas_leapfrog(interpret=True)`` on JAX's wrapped dc forms
at rtol 2e-5 / atol 2e-6, as tests/test_precondition.py:205-215 holds
Pallas against XLA; Kernel 3's twin against ``make_pallas_subtree(
interpret=True)`` per chain, as tests/test_torch_nuts_kernels.py.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    nuts_sampler_kwargs,
    preconditioner_from_numpy,
    sampler_kwargs,
)
from mini_mcmc_torch.models import (
    Preconditioner,
    estimate_preconditioner,
    precondition_target,
)
from mini_mcmc_torch.ops.kernels.hmc import leapfrog_trajectory
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree, subtree_plain
from mini_mcmc_tpu import HMC as JaxHMC
from mini_mcmc_tpu import NUTS as JaxNUTS
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models.precondition import Preconditioner as JaxPre
from mini_mcmc_tpu.ops.pallas.hmc import make_pallas_leapfrog
from mini_mcmc_tpu.ops.pallas.nuts_subtree import make_pallas_subtree

torch.set_num_threads(1)

MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
CPU = dict(device="cpu")
TOL = {np.float32: dict(rtol=1e-6, atol=1e-7),
       np.float64: dict(rtol=1e-12, atol=1e-14)}


def _matrix(d, kind, seed, dtype=np.float64):
    """A diag scale or a dense Cholesky factor, from a seed."""
    g = np.random.default_rng(seed)
    if kind == "diag":
        return g.uniform(0.5, 2.0, d).astype(dtype)
    a = g.standard_normal((d, d))
    return np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(dtype)


def _pres(d, kind, seed, dtype):
    arr = _matrix(d, kind, seed, dtype)
    key = "scale" if kind == "diag" else "chol"
    return (Preconditioner(kind, **{key: torch.from_numpy(arr)}),
            JaxPre(kind, **{key: jnp.asarray(arr)}))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _grad_close(got, want, rtol=1e-5):
    """Per row, within rtol of each entry plus rtol of the row's largest
    |g| (the cancellation in x_{i+1} - x_i^2 near a component's zero)."""
    got, want = _np(got), _np(want)
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want) - rtol * (np.abs(want) + scale)
    assert (err <= 0).all(), float(err.max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_preconditioner_maps_match_jax(kind, dtype):
    pre, jpre = _pres(3, kind, seed=1, dtype=dtype)
    x = np.random.default_rng(2).standard_normal((64, 3)).astype(dtype)
    tol = TOL[dtype]
    for name in ("to_x", "to_y", "grad_to_y"):
        got = getattr(pre, name)(torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(_np(got), _np(getattr(jpre, name)(
            jnp.asarray(x))), err_msg=name, **tol)
    # a [K, C, D] stack maps row by row
    stack = np.stack([x, 2 * x])
    np.testing.assert_allclose(_np(pre.to_y(torch.from_numpy(stack))),
                               _np(jpre.to_y(jnp.asarray(stack))), **tol)
    np.testing.assert_allclose(_np(pre.to_x(pre.to_y(torch.from_numpy(x)))),
                               x, rtol=100 * tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(float(pre.logdet()), float(jpre.logdet()),
                               rtol=tol["rtol"])
    assert pre.sigma_min() == pytest.approx(jpre.sigma_min(),
                                            rel=tol["rtol"])
    assert pre.dim == jpre.dim == 3


def test_preconditioner_validates_construction():
    with pytest.raises(ValueError, match="kind"):
        Preconditioner(kind="Diag", scale=torch.ones(2))
    with pytest.raises(ValueError, match="chol"):
        Preconditioner(kind="dense", scale=torch.ones(2))
    with pytest.raises(ValueError, match="scale"):
        Preconditioner(kind="diag", chol=torch.eye(2))
    with pytest.raises(ValueError, match="chol"):
        Preconditioner(kind="dense", chol=torch.ones(2))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_estimate_preconditioner_matches_jax(kind, dtype):
    g = np.random.default_rng(3)
    chol = np.linalg.cholesky(np.array([[4.0, 2.0, 0.5], [2.0, 3.0, 0.2],
                                        [0.5, 0.2, 0.3]]))
    x = (g.standard_normal((4096, 3)) @ chol.T + [0.0, 1.0, -2.0]).astype(
        dtype)
    got = estimate_preconditioner(torch.from_numpy(x), kind)
    if dtype == np.float32:
        with jax.enable_x64(False):
            want = jm.estimate_preconditioner(jnp.asarray(x), kind)
            want = np.asarray(want.scale if kind == "diag" else want.chol)
        rtol = 1e-5
    else:
        want = jm.estimate_preconditioner(jnp.asarray(x), kind)
        want = np.asarray(want.scale if kind == "diag" else want.chol)
        rtol = 1e-10
    arr = got.scale if kind == "diag" else got.chol
    assert arr.dtype == torch.from_numpy(x).dtype and want.dtype == dtype
    np.testing.assert_allclose(_np(arr), want, rtol=rtol, atol=rtol * 1e-3)
    # float16 ensembles are estimated in float32
    half = estimate_preconditioner(torch.from_numpy(x).half(), kind)
    assert (half.scale if kind == "diag" else half.chol).dtype == \
        torch.float32
    with pytest.raises(ValueError, match="kind"):
        estimate_preconditioner(torch.from_numpy(x), "full")
    with pytest.raises(ValueError, match="n_chains"):
        estimate_preconditioner(torch.from_numpy(x[0]), kind)


def _targets():
    return {
        "rosenbrock3": (mt.rosenbrock_nd(), jm.rosenbrock_nd(), 3),
        "gaussian2d": (mt.diffable_gaussian2d(MEAN, COV),
                       jm.diffable_gaussian2d(MEAN, COV), 2),
    }


@pytest.mark.parametrize("kind", ["diag", "dense"])
@pytest.mark.parametrize("which", ["rosenbrock3", "gaussian2d"])
def test_precondition_target_matches_jax(which, kind):
    t, jt, d = _targets()[which]
    pre, jpre = _pres(d, kind, seed=4, dtype=np.float32)
    w, jw = precondition_target(t, pre), jm.precondition_target(jt, jpre)
    y = (np.random.default_rng(5).standard_normal((256, d)) * 0.4).astype(
        np.float32)
    lp, grad = w.batch_logp_and_grad(torch.from_numpy(y))
    jlp, jgrad = jw.batch_logp_and_grad(jnp.asarray(y))
    np.testing.assert_allclose(_np(lp), np.asarray(jlp), rtol=1e-5)
    _grad_close(grad, jgrad)
    # the analytic chain rule equals autograd of the wrapped logp
    _grad_close(mt.models.Target(logp=w.logp).batch_grad(torch.from_numpy(
        y)), grad)
    if t.logp_normalized is not None:
        np.testing.assert_allclose(
            _np(w.logp_normalized(torch.from_numpy(y))),
            np.asarray(jax.vmap(jw.logp_normalized)(jnp.asarray(y))),
            rtol=1e-5)
    # the kernels' form: the inner functor, L's lower triangle first
    ell = _np(pre.matrix).astype(np.float64)
    assert w.cuda_affine and w.cuda_functor == t.cuda_functor
    assert w.cuda_params == tuple(ell[np.tril_indices(d)]) + t.cuda_params


def test_whitening_twice_composes_one_affine_form():
    t = mt.diffable_gaussian2d(MEAN, COV)
    a, _ = _pres(2, "dense", seed=6, dtype=np.float64)
    b, _ = _pres(2, "diag", seed=7, dtype=np.float64)
    twice = precondition_target(precondition_target(t, a), b)
    once = precondition_target(t, Preconditioner(
        "dense", chol=a.chol @ b.matrix))
    np.testing.assert_allclose(twice.cuda_params, once.cuda_params,
                               rtol=1e-12)
    y = torch.randn(16, 2, dtype=torch.float64)
    np.testing.assert_allclose(_np(twice.batch_logp(y)),
                               _np(once.batch_logp(y)), rtol=1e-12)


def test_diag_whitening_at_large_d_builds_no_square():
    """A diag metric at D=10,000 builds in well under a second with no
    D^2 parameters (the lower triangle would be 50,005,000 floats); at
    D <= 4 the kernels' parameters are L's triangle as before."""
    import time

    pre = Preconditioner("diag", scale=torch.logspace(-1, 1, 10_000))
    t0 = time.perf_counter()
    w = precondition_target(mt.standard_normal(), pre)
    h = mt.HMC(mt.standard_normal(), torch.zeros((4, 10_000)), 0.1, 2,
               use_pallas="separable", metric=pre, **CPU)
    assert time.perf_counter() - t0 < 1.0
    assert pre.dim == 10_000 and w.cuda_params == () and w.cuda_affine
    assert h.kernel_target.cuda_params == ()
    iso = mt.models.isotropic_gaussian_target(2.0)
    assert precondition_target(iso, pre).cuda_params == (2.0,)
    for d in (2, 3, 4):
        for kind in ("diag", "dense"):
            small, _ = _pres(d, kind, seed=d, dtype=np.float32)
            ell = _np(small.matrix).astype(np.float64)
            want = tuple(float(ell[i, j]) for i in range(d)
                         for j in range(i + 1))
            t = mt.rosenbrock_nd()
            assert precondition_target(t, small).cuda_params == (
                want + t.cuda_params)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_twin_on_whitened_target_matches_jax_pallas(kind):
    # tests/test_precondition.py:205-215 through the port: Kernel 1's twin
    # on the whitened target against the Pallas trajectory on JAX's
    # wrapped chains-on-lanes forms, same momenta
    pre, jpre = _pres(2, kind, seed=8, dtype=np.float32)
    jw = jm.precondition_target(jm.diffable_gaussian2d(MEAN, COV), jpre)
    w = precondition_target(mt.diffable_gaussian2d(MEAN, COV), pre)
    g = np.random.default_rng(9)
    y = g.standard_normal((64, 2)).astype(np.float32)
    mom = g.standard_normal((64, 2)).astype(np.float32)
    eps, n_leapfrog = 0.3, 8
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
        np.testing.assert_allclose(_np(a), b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_subtree_twin_on_whitened_target_matches_jax_pallas(kind):
    c, j = 1024, 4  # one JAX grid block: JAX's lane id is the chain index
    pre, jpre = _pres(2, kind, seed=10, dtype=np.float32)
    jw = jm.precondition_target(jm.diffable_gaussian2d(MEAN, COV), jpre)
    w = precondition_target(mt.diffable_gaussian2d(MEAN, COV), pre)
    g = np.random.default_rng(11)
    y = g.standard_normal((c, 2)).astype(np.float32)
    mom = g.standard_normal((c, 2)).astype(np.float32)
    lp, grad = w.batch_logp_and_grad(torch.from_numpy(y))
    joint0 = (_np(lp) - 0.5 * (mom * mom).sum(1)).astype(np.float32)
    logu = (joint0 - g.exponential(size=c)).astype(np.float32)
    v = np.where(g.uniform(size=c) < 0.5, -1, 1).astype(np.int32)
    eps = g.uniform(0.3, 1.2, size=c).astype(np.float32)
    active = g.uniform(size=c) < 0.75
    seed = (123457, -98765)
    f32 = jnp.float32
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
    # per chain: the same counts and flags, and the floats where the
    # subtree continues (s), as tests/test_torch_nuts_kernels.py
    same = np.ones(c, bool)
    for k in (6, 7, 9, 10):  # n, s, n_alpha, diverged
        same &= got[k] == want[k]
    same &= np.isclose(got[8], want[8], rtol=1e-5, atol=1e-6)  # alpha
    s = want[7].astype(bool)
    for a, b in zip(got[:6], want[:6]):
        ok = np.isclose(a, b, rtol=1e-5, atol=1e-6).reshape(c, -1).all(1)
        same &= ok | ~s
    assert same.mean() >= 0.999, same.mean()
    assert s.any() and (~s).any()


@pytest.mark.parametrize("tier", [False, True, "full"])
def test_hmc_metric_rows_and_positions_are_x_space(tier):
    # tests/test_precondition.py:121-135: under K-step blocks the rows are
    # un-whitened too (x-space dim 0 has std 2, whitened it would be 1)
    pre = Preconditioner("dense", chol=torch.linalg.cholesky(
        torch.tensor(COV)))
    init = mt.init_det(64, 2, device="cpu")
    h = mt.HMC(mt.diffable_gaussian2d(MEAN, COV), init, 0.9, 8,
               use_pallas=tier, steps_per_call=5, metric=pre, **CPU).seed(6)
    s = h.run(200, 100)
    flat = _np(s).reshape(-1, 2)
    assert flat[:, 0].std() > 1.5, flat[:, 0].std()
    np.testing.assert_allclose(flat.mean(axis=0), MEAN, atol=0.25)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.7)
    # the last row is .positions, the state mapped to x
    torch.testing.assert_close(s[:, -1], h.positions)
    torch.testing.assert_close(h.positions, pre.to_x(h.state.positions))
    assert float(h.positions[:, 0].std()) > 1.0
    assert h.kernel_target.cuda_affine and h.metric is not None


def _wide():
    def logp(x):
        return -0.5 * torch.sum((x / 100.0) ** 2, dim=-1)

    return mt.models.Target(logp=logp)


def test_hmc_reconditioned_step_size_is_the_jax_formula():
    # eps_y = eps_x / sigma_min(new), with eps_x = eps_y * sigma_min(old)
    # on a sampler that already has a metric (test_precondition.py:299-323)
    x = np.random.default_rng(13).standard_normal((128, 2)).astype(
        np.float32) * 100.0
    h = mt.HMC(_wide(), torch.from_numpy(x), 50.0, 8, **CPU).seed(12)
    tuned = h.reconditioned("diag")
    with jax.enable_x64(False):
        want = jm.estimate_preconditioner(jnp.asarray(x), "diag")
    assert tuned.step_size == pytest.approx(50.0 / want.sigma_min(),
                                            rel=1e-5)
    assert 0.2 < tuned.step_size < 1.5
    tuned.run(0, 50)
    again = tuned.reconditioned("diag", n_leapfrog=4)
    with jax.enable_x64(False):
        want2 = jm.estimate_preconditioner(
            jnp.asarray(_np(tuned.positions)), "diag")
    assert again.step_size == pytest.approx(
        tuned.step_size * tuned.metric.sigma_min() / want2.sigma_min(),
        rel=1e-5)
    assert again.n_leapfrog == 4
    assert tuned.reconditioned("dense", step_size=0.7).step_size == 0.7
    s = again.run(100, 0)
    assert 70.0 < float(s.std()) < 135.0


def test_reconditioned_is_deterministic_without_seed():
    t = mt.diffable_gaussian2d(MEAN, COV)

    def hmc_workflow():
        h = mt.HMC(t, mt.init_det(32, 2, **CPU), 0.25, 8, **CPU).seed(21)
        h.run(0, 50)
        return h.reconditioned("dense").run(20, 0)

    def nuts_workflow():
        n = mt.NUTS(t, mt.init_det(32, 2, **CPU), 0.8, **CPU).seed(22)
        n.run(0, 20)
        return n.reconditioned("dense").run(10, 5)

    for workflow in (hmc_workflow, nuts_workflow):
        torch.testing.assert_close(workflow(), workflow(), rtol=0, atol=0)


def test_nuts_warmed_up_one_call_workflow():
    t = mt.diffable_gaussian2d(MEAN, COV)
    init = mt.init_det(128, 2, **CPU)
    nuts = mt.NUTS(t, init, 0.8, **CPU).seed(8)
    w = nuts.warmed_up(150, "diag", seed=9)
    np.testing.assert_allclose(_np(w.metric.scale), [2.0, np.sqrt(3.0)],
                               rtol=0.35)
    assert float(w.step_size[0]) == -1.0  # found again on its first run
    s = w.run(200, 100)
    np.testing.assert_allclose(_np(s).reshape(-1, 2).mean(axis=0), MEAN,
                               atol=0.2)
    # the adaptation leg advanced the parent's chains in place
    assert not torch.allclose(nuts.positions, init)


@pytest.mark.parametrize("tier", [False, True, "full"])
def test_nuts_dense_metric_passes_the_bench_gates(tier):
    # bench.py:363-379 at 2,048 chains: reconditioned("dense") from an
    # adapted ensemble, an adaptation run, then the gated run
    c, n = 2048, 128
    init = mt.init_with_seed(c, 2, seed=7, **CPU)
    nuts = mt.NUTS(mt.diffable_gaussian2d(MEAN, COV), init, 0.8,
                   use_pallas=tier, **CPU).seed(7)
    nuts.run(0, 64)
    tuned = nuts.reconditioned("dense", seed=11)
    tuned.run(64, 64)
    sample = tuned.run(n, 32)
    assert sample.shape == (c, n, 2) and torch.isfinite(sample).all()
    rhat, ess = mt.split_rhat_mean_ess(sample)
    assert 0.95 <= float(rhat.mean()) <= 1.05
    assert float(ess.min()) >= 0.01 * c * n
    flat = sample.reshape(-1, 2).double()
    var = flat.var(dim=0, unbiased=False)
    for d in range(2):
        assert abs(float(flat[:, d].mean()) - MEAN[d]) <= 0.08
        assert abs(float(var[d]) - COV[d][d]) <= 0.4


def test_metric_errors_and_separable_diag_twin():
    t = mt.diffable_gaussian2d(MEAN, COV)
    x = mt.init_det(8, 2, **CPU)
    for make in (lambda **k: mt.NUTS(t, x, 0.8, **k, **CPU),
                 lambda **k: mt.HMC(t, x, 0.1, 4, **k, **CPU)):
        with pytest.raises(ValueError,
                           match="metric must be a Preconditioner"):
            make(metric=object())
        with pytest.raises(ValueError, match="D=3 metric"):
            make(metric=Preconditioner("diag", scale=torch.ones(3)))
        with pytest.raises(ValueError, match="transform"):
            make(transform=object())
    # a diagonal metric keeps separability: the tier's twin runs it
    pre = Preconditioner("diag", scale=torch.linspace(0.5, 2.0, 12))
    h = mt.HMC(mt.standard_normal(), mt.init_with_seed(64, 12, seed=1, **CPU),
               0.2, 8, use_pallas="separable", metric=pre, **CPU).seed(1)
    s = h.run(64, 64)
    assert abs(float(s.var()) - 1.0) < 0.15
    # dense whitening couples the coordinates: the tier rejects it
    dense = Preconditioner("dense", chol=torch.eye(12) + 0.1 * torch.tril(
        torch.ones(12, 12), -1))
    with pytest.raises(ValueError, match="not coordinate-separable"):
        mt.HMC(mt.standard_normal(), mt.init_det(8, 12, **CPU), 0.2, 8,
               use_pallas="separable", metric=dense, **CPU)


def test_convert_carries_a_metric_across():
    jt = jm.diffable_gaussian2d(MEAN, COV)
    init = np.zeros((16, 2), np.float32)
    for kind, arr in (("diag", np.array([2.0, 1.5])),
                      ("dense", np.linalg.cholesky(np.array(COV)))):
        key = "scale" if kind == "diag" else "chol"
        jpre = JaxPre(kind, **{key: jnp.asarray(arr)})
        for jax_sampler, to_kwargs, ctor in (
                (JaxHMC(jt, init, 0.9, 8, metric=jpre), sampler_kwargs,
                 lambda kw: mt.HMC(mt.diffable_gaussian2d(MEAN, COV),
                                   init, **kw, **CPU)),
                (JaxNUTS(jt, init, 0.8, metric=jpre), nuts_sampler_kwargs,
                 lambda kw: mt.NUTS(mt.diffable_gaussian2d(MEAN, COV),
                                    init, **kw, **CPU))):
            kw = to_kwargs(jax_sampler)
            got = getattr(kw["metric"], key)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_allclose(_np(got), arr, rtol=1e-6)
            sampler = ctor(kw)
            assert sampler.metric.kind == kind
            assert tuple(sampler.run(4, 2).shape) == (16, 4, 2)
    with pytest.raises(ValueError, match="metric must be a Preconditioner"):
        sampler_kwargs(SimpleNamespace(_ctor={}, metric=object()))
    pre = preconditioner_from_numpy("dense", np.eye(2), device="cpu")
    assert pre.kind == "dense" and pre.chol.dtype == torch.float32
