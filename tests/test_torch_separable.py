"""The separable HMC tier (``use_pallas="separable"``, Kernel 7) against
the JAX package.

Kernel 7's twin with the momentum as input is held against the JAX
package's ``make_pallas_hmc_separable(interpret=True, mom_input=True)`` on
the same numpy inputs at rtol = atol = 1e-5, as
``tests/test_pallas.py:731,898`` hold that kernel against the XLA
leapfrog. ``validate_separable`` accepts and rejects the targets the JAX
validator does. The sampler tier runs the twin on CPU tensors (the CUDA
kernel is held against it in ``tests/test_torch_cuda.py``) and passes the
moment gates of ``bench.py:635-640`` at a reduced size: D = 64, 256
chains, 128 + 128 draws (cut from D = 10,000 and 1,024 chains).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.convert import (
    hmc_sep_state_from_numpy,
    sampler_kwargs,
    state_to_numpy,
)
from mini_mcmc_torch.models import Target, validate_separable
from mini_mcmc_torch.ops.hmc import HMCSepState
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.hmc_sep import (
    accept_uniforms,
    hmc_separable,
    hmc_separable_plain,
    hmc_separable_step,
    hmc_separable_step_plain,
    sep_functor,
    sep_fused,
    sep_tiles,
)
import mini_mcmc_tpu as jmt
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.pallas.hmc_bigd import make_pallas_hmc_separable

torch.set_num_threads(1)

TOL = 1e-5


def _sigma_targets(sigma: np.ndarray):
    """The heterogeneous Gaussian of tests/test_pallas.py:898-942 in both
    packages: one sigma per coordinate, carried by a sep_form table."""
    js = jnp.asarray(sigma)

    def j_batch(x):
        return jnp.sum(-0.5 * (x / js.astype(x.dtype)) ** 2, axis=-1)

    def j_tile(x, s):
        return jnp.sum(-0.5 * (x / s.astype(x.dtype)) ** 2, axis=-1)

    jt = jm.Target(logp=lambda x: j_batch(x[None, :])[0],
                   logp_batch=j_batch, sep_form=(j_tile, (js,)))
    ts = torch.from_numpy(sigma)

    def t_tile(x, s):
        return torch.sum(-0.5 * (x / s.to(x.dtype)) ** 2, dim=-1)

    tt = Target(logp=lambda x: t_tile(x, ts), sep_form=(t_tile, (ts,)),
                cuda_functor="sigma_table_normal")
    return jt, tt


@pytest.mark.parametrize("case", ["standard_normal", "sigma_table"])
def test_twin_matches_interpreted_pallas_kernel(case):
    """tests/test_pallas.py:731 (standard normal, L=7, eps=0.12) and :898
    (sigma table, L=5, eps=0.08), C=8, D=40 over [4, 10] JAX tiles."""
    g = np.random.RandomState(0 if case == "standard_normal" else 3)
    c, d = 8, 40
    if case == "standard_normal":
        n_leapfrog, eps = 7, 0.12
        jt, tt = jm.standard_normal(), mt.standard_normal()
    else:
        n_leapfrog, eps = 5, 0.08
        jt, tt = _sigma_targets((0.5 + g.rand(d)).astype(np.float32))
    pos = g.randn(c, d).astype(np.float32)
    mom = g.randn(c, d).astype(np.float32)

    fn, tabs = jt.sep_forms()
    traj = make_pallas_hmc_separable(fn, n_leapfrog, n_tables=len(tabs),
                                     interpret=True, mom_input=True,
                                     block_c=4, block_d=10)
    jtabs = tuple(jnp.asarray(t, jnp.float32).reshape(1, -1) for t in tabs)
    pos_j, mom_j, pe, ke0, ke1 = (np.asarray(a) for a in traj(
        jnp.asarray(pos), jnp.asarray(mom), eps, *jtabs))

    tables = torch.cat([t.float() for t in tt.sep_forms()[1]]) if tabs \
        else torch.empty((0, d))
    calls = hmc_separable_plain.calls
    pos_t, logp_t, ke0_t, ke1_t, mom_t = hmc_separable(
        tt, torch.from_numpy(pos), torch.tensor([eps]), n_leapfrog, 0, 0,
        tables, torch.from_numpy(mom))
    assert hmc_separable_plain.calls == calls + 1  # CPU tensors: the twin
    for got, want in ((pos_t, pos_j), (mom_t, mom_j),
                      (logp_t, pe.sum(1)), (ke0_t, ke0.sum(1)),
                      (ke1_t, ke1.sum(1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _strict_targets():
    """A correlated density whose batch form does fixed-D linear algebra:
    a narrowed slice raises (tests/test_pallas.py:878-895)."""
    prec = np.linalg.inv([[2.0, 0.5], [0.5, 1.0]]).astype(np.float32)
    jp, tp = jnp.asarray(prec), torch.from_numpy(prec)

    def j_strict(x):
        return -0.5 * jnp.sum((x @ jp) * x, axis=-1)

    def t_strict(x):
        return -0.5 * torch.sum((x @ tp) * x, dim=-1)

    return (jm.Target(logp=lambda x: j_strict(x[None, :])[0],
                      logp_batch=j_strict), Target(logp=t_strict))


def _bad_table_targets():
    """A sep_form that ignores its table (tests/test_pallas.py:1010)."""
    sigma = np.linspace(0.5, 2.0, 9, dtype=np.float32)
    jt, tt = _sigma_targets(sigma)

    def j_bad(x, s):
        return jnp.sum(-0.5 * x ** 2, axis=-1)

    def t_bad(x, s):
        return torch.sum(-0.5 * x ** 2, dim=-1)

    return (jm.Target(logp=jt.logp, logp_batch=jt.logp_batch,
                      sep_form=(j_bad, jt.sep_form[1])),
            Target(logp=tt.logp, sep_form=(t_bad, tt.sep_form[1])))


_BLK = 1024


def _blocky_targets():
    """tests/test_pallas.py:1046: an iid base plus a coupled term per
    1024-wide block of the slice, additive across block-aligned cuts only
    (the three-chunk cuts of d = 9216 are; the coordinates are not)."""

    def blocky(x, xp):
        cc, w = x.shape
        nb = w // _BLK
        out = xp.sum(-0.5 * x * x, -1)
        if nb:
            b = x[:, :nb * _BLK].reshape(cc, nb, _BLK)
            out = out - 0.5 * xp.sum(xp.sum(b, -1) ** 2, -1) / _BLK
        if w - nb * _BLK:
            out = out - 0.5 * xp.sum(x[:, nb * _BLK:], -1) ** 2 / _BLK
        return out

    return (jm.Target(logp=lambda x: blocky(x[None, :], jnp)[0],
                      logp_batch=lambda x: blocky(x, jnp)),
            Target(logp=lambda x: blocky(x, torch)))


def _pair(name):
    """(JAX target, port target, [C, D] float32 probe positions)."""
    d = {"standard_normal": 6, "isotropic_gaussian": 6, "sigma_table": 9,
         "gaussian2d": 2, "rosenbrock_nd": 3, "strict": 2, "bad_table": 9,
         "blocky": 9216}[name]
    c = 100 if name == "blocky" else 16
    x = np.random.default_rng(4).standard_normal((c, d)).astype(np.float32)
    if name == "standard_normal":
        return jm.standard_normal(), mt.standard_normal(), x
    if name == "isotropic_gaussian":
        return (jm.isotropic_gaussian_target(2.0),
                mt.models.isotropic_gaussian_target(2.0), x)
    if name == "sigma_table":
        return (*_sigma_targets(np.linspace(0.5, 2.0, d, dtype=np.float32)),
                x)
    if name == "gaussian2d":
        cov = [[2.0, 0.5], [0.5, 1.0]]
        return (jm.gaussian2d([0.0, 0.0], cov),
                mt.gaussian2d([0.0, 0.0], cov), x)
    if name == "rosenbrock_nd":
        return jm.rosenbrock_nd(), mt.rosenbrock_nd(), x
    if name == "strict":
        return (*_strict_targets(), x)
    if name == "bad_table":
        return (*_bad_table_targets(), x)
    return (*_blocky_targets(), x)


@pytest.mark.parametrize("name,separable", [
    ("standard_normal", True), ("isotropic_gaussian", True),
    ("sigma_table", True), ("gaussian2d", False), ("rosenbrock_nd", False),
    ("strict", False), ("bad_table", False), ("blocky", False)])
def test_validate_separable_agrees_with_jax(name, separable):
    jt, tt, x = _pair(name)

    def verdict(fn, *args):
        try:
            fn(*args)
        except ValueError as e:
            assert "separable" in str(e), e
            return False
        return True

    assert verdict(jm.validate_separable, jt, jnp.asarray(x)) is separable
    assert verdict(validate_separable, tt, torch.from_numpy(x)) is separable
    # the sampler validates at construction, on every device
    if not separable:
        with pytest.raises(ValueError, match="separable"):
            mt.HMC(tt, x, 0.1, 3, use_pallas="separable", device="cpu")


def test_sep_form_tables_are_checked_by_shape():
    bad = torch.ones((2, 4))
    t = Target(logp=lambda x: torch.sum(-0.5 * x * x, dim=-1),
               sep_form=(lambda x, s: torch.sum(-0.5 * x * x, dim=-1),
                         (bad,)))
    with pytest.raises(ValueError, match=r"\(2, 4\)"):
        t.sep_forms()
    short = Target(logp=lambda x: torch.sum(-0.5 * x * x, dim=-1),
                   sep_form=(lambda x, s: torch.sum(-0.5 * x * x, dim=-1),
                             (torch.ones(3),)))
    with pytest.raises(ValueError, match="cover all D=8"):
        validate_separable(short, torch.zeros((4, 8)))


def test_coordinate_functors_are_named():
    assert sep_functor(mt.standard_normal()) == (0, 0)
    assert sep_functor(mt.models.isotropic_gaussian_target(2.0)) == (1, 0)
    assert sep_functor(_sigma_targets(np.ones(4, np.float32))[1]) == (2, 1)
    # a target without a coordinate functor runs its own (id -1)
    assert sep_functor(Target(logp=mt.standard_normal().logp)) == (-1, 0)
    with pytest.raises(ValueError, match="unknown"):
        sep_functor(mt.rosenbrock_nd())
    # the D-tiles of one launch: 2 quads of 4 coordinates per thread
    assert sep_tiles(10_000) == 5 and sep_tiles(10_000, 64) == 20
    assert sep_tiles(40) == sep_tiles(1) == 1
    # the fused form's shape rule: at most 16 tiles, one cluster a chain
    assert sep_fused(32_768) and not sep_fused(32_769)
    assert sep_fused(10_000) and not sep_fused(10_000, 64)
    assert sep_tiles(10_000, 128) == 10 and sep_fused(10_000, 128)


@pytest.mark.parametrize("case", ["standard_normal", "sigma_table"])
def test_twin_on_a_diag_whitened_target_matches_interpreted_pallas(case):
    """The scaled instance's twin: the whitened ``sep_form`` (the scale as
    the last table) against ``make_pallas_hmc_separable(interpret=True,
    mom_input=True)`` on JAX's whitened target, C=8, D=40 over [4, 10] JAX
    tiles, as above."""
    g = np.random.RandomState(5 if case == "standard_normal" else 6)
    c, d, n_leapfrog, eps = 8, 40, 6, 0.1
    if case == "standard_normal":
        jt, tt = jm.standard_normal(), mt.standard_normal()
    else:
        jt, tt = _sigma_targets((0.5 + g.rand(d)).astype(np.float32))
    scale = (0.3 + 2.0 * g.rand(d)).astype(np.float32)
    jw = jm.precondition_target(jt, jm.Preconditioner(
        "diag", scale=jnp.asarray(scale)))
    tw = mt.precondition_target(tt, mt.Preconditioner(
        "diag", scale=torch.from_numpy(scale)))
    pos = g.randn(c, d).astype(np.float32)
    mom = g.randn(c, d).astype(np.float32)

    fn, tabs = jw.sep_forms()
    traj = make_pallas_hmc_separable(fn, n_leapfrog, n_tables=len(tabs),
                                     interpret=True, mom_input=True,
                                     block_c=4, block_d=10)
    jtabs = tuple(jnp.asarray(t, jnp.float32).reshape(1, -1) for t in tabs)
    pos_j, mom_j, pe, ke0, ke1 = (np.asarray(a) for a in traj(
        jnp.asarray(pos), jnp.asarray(mom), eps, *jtabs))

    n_inner = len(tt.sep_forms()[1])
    assert tw.cuda_scaled and sep_functor(tw)[1] == n_inner + 1
    tables = torch.cat([t.float() for t in tw.sep_forms()[1]])
    assert tables.shape == (n_inner + 1, d) and len(tabs) == n_inner + 1
    pos_t, logp_t, ke0_t, ke1_t, mom_t = hmc_separable(
        tw, torch.from_numpy(pos), torch.tensor([eps]), n_leapfrog, 0, 0,
        tables, torch.from_numpy(mom))
    for got, want in ((pos_t, pos_j), (mom_t, mom_j),
                      (logp_t, pe.sum(1)), (ke0_t, ke0.sum(1)),
                      (ke1_t, ke1.sum(1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_only_a_target_whitened_once_by_a_diag_metric_is_scaled():
    d = 12
    diag = mt.Preconditioner("diag", scale=torch.linspace(0.5, 2.0, d))
    dense = mt.Preconditioner("dense", chol=torch.eye(d))
    for t, fid, n in ((mt.standard_normal(), 0, 0),
                      (mt.models.isotropic_gaussian_target(2.0), 1, 0),
                      (_sigma_targets(np.ones(d, np.float32))[1], 2, 1)):
        w = mt.precondition_target(t, diag)
        assert w.cuda_scaled and w.cuda_params == t.cuda_params
        assert sep_functor(w) == (fid, n + 1)
        # whitened twice, or by a dense metric: no form the kernel runs
        for bad in (mt.precondition_target(w, diag),
                    mt.precondition_target(t, dense),
                    mt.precondition_target(mt.precondition_target(
                        t, dense), diag)):
            assert bad.cuda_affine and not bad.cuda_scaled
            with pytest.raises(ValueError, match="whitens it once"):
                sep_functor(bad)


@pytest.mark.parametrize("d,chain0", [(40, 0), (10, 3), (7, 2**32 - 2)])
def test_paired_normals_are_the_philox_words(d, chain0):
    """The twin's paired Box-Muller momenta from the Philox twin's words:
    the counter (chain, step, q, 0) gives coordinates 4q..4q+3, the cosine
    branch bit for bit the single normal of the other kernels."""
    c, step, seed = 16, 2**31 + 9, 0x0123456789ABCDEF
    got = rng.paired_normals(c, d, step, seed, chain0=chain0)
    assert got.shape == (c, d) and got.dtype == torch.float32
    for q in range((d + 3) // 4):
        w = rng.philox4x32_10(torch.arange(chain0, chain0 + c), step, q, 0,
                              rng.seed_words(seed))
        want = [*rng.box_muller_pair(w[0], w[1]),
                *rng.box_muller_pair(w[2], w[3])]
        assert torch.equal(want[0], rng.box_muller(w[0], w[1]))
        for i in range(min(4, d - 4 * q)):
            assert torch.equal(got[:, 4 * q + i], want[i])
    assert abs(float(rng.paired_normals(512, 64, 0, 1).std()) - 1.0) < 0.02


def test_twin_draws_its_momentum_from_the_paired_stream():
    t = mt.standard_normal()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 13)).astype(np.float32))
    eps, tables = torch.tensor([0.05]), torch.empty((0, 13))
    drawn = hmc_separable(t, x, eps, 4, 77, 12, tables)
    mom = rng.paired_normals(6, 13, 12, 77)
    given = hmc_separable(t, x, eps, 4, 77, 12, tables, mom)
    for a, b in zip(drawn[:4], given[:4]):
        assert torch.equal(a, b)
    assert drawn[4] is None and given[4].shape == (6, 13)
    np.testing.assert_allclose(drawn[2].numpy(),
                               (0.5 * (mom * mom).sum(1)).numpy(), rtol=1e-6)


def _truncated_targets():
    """A standard normal cut at x = 3 (-inf past it) in both packages: a
    trajectory that crosses the cut proposes at logp = -inf."""

    def j_tile(x):
        return jnp.sum(jnp.where(x < 3.0, -0.5 * x * x, -jnp.inf), axis=-1)

    def t_tile(x):
        return torch.sum(torch.where(x < 3.0, -0.5 * x * x,
                                     torch.tensor(-float("inf"))), dim=-1)

    return (jm.Target(logp=lambda x: j_tile(x[None, :])[0],
                      logp_batch=j_tile, sep_form=(j_tile, ())),
            Target(logp=t_tile, sep_form=(t_tile, ())))


@pytest.mark.parametrize("case", ["truncated", "scaled_sigma_table"])
def test_fused_twin_matches_pallas_kernel_and_jax_accept(case):
    """The fused step's twin, given the momentum and the accept uniforms,
    against ``make_pallas_hmc_separable(interpret=True, mom_input=True)``
    followed by the accept of ``mini_mcmc_tpu/ops/hmc.py:203-214`` in jnp,
    at 1e-5: positions, logp and alpha_c. C=8, D=40 over [4, 10] JAX
    tiles. On the truncated normal chain 0 proposes NaN (a NaN momentum)
    and chain 1 crosses the cut (logp -inf): both are rejected with
    alpha_c 0. The scaled case is the sigma table whitened by a diagonal
    metric (the scaled instance's twin)."""
    g = np.random.RandomState(11 if case == "truncated" else 12)
    # a step large enough that some proposals lose energy and are rejected
    c, d, n_leapfrog = 8, 40, 6
    eps = 0.1 if case == "truncated" else 0.4
    pos = (0.5 * g.randn(c, d)).astype(np.float32)
    mom = g.randn(c, d).astype(np.float32)
    u = g.uniform(1e-6, 1.0, c).astype(np.float32)
    if case == "truncated":
        jt, tt = _truncated_targets()
        mom[0, 3] = np.nan
        mom[1, 0] = 60.0
        logp_in = np.sum(-0.5 * pos * pos, axis=1, dtype=np.float32)
    else:
        sigma = (0.5 + g.rand(d)).astype(np.float32)
        scale = (0.3 + 2.0 * g.rand(d)).astype(np.float32)
        jt0, tt0 = _sigma_targets(sigma)
        jt = jm.precondition_target(jt0, jm.Preconditioner(
            "diag", scale=jnp.asarray(scale)))
        tt = mt.precondition_target(tt0, mt.Preconditioner(
            "diag", scale=torch.from_numpy(scale)))
        z = pos * scale / sigma
        logp_in = np.sum(-0.5 * z * z, axis=1, dtype=np.float32)

    fn, tabs = jt.sep_forms()
    traj = make_pallas_hmc_separable(fn, n_leapfrog, n_tables=len(tabs),
                                     interpret=True, mom_input=True,
                                     block_c=4, block_d=10)
    jtabs = tuple(jnp.asarray(t, jnp.float32).reshape(1, -1) for t in tabs)
    pos_p, _, pe, ke0, ke1 = traj(jnp.asarray(pos), jnp.asarray(mom), eps,
                                  *jtabs)
    # ops/hmc.py:_sep_step's accept, as the JAX package writes it
    logp_prop = jnp.sum(pe, axis=1)
    accept_logp = (-jnp.asarray(logp_in) + jnp.sum(ke0, axis=1)) - (
        -logp_prop + jnp.sum(ke1, axis=1))
    alpha_c = jnp.exp(jnp.minimum(accept_logp, 0.0))
    alpha_c = jnp.where(jnp.isnan(alpha_c), 0.0, alpha_c)
    accept = accept_logp >= jnp.log(jnp.asarray(u))
    want = (np.asarray(jnp.where(accept[:, None], pos_p, pos)),
            np.asarray(jnp.where(accept, logp_prop, logp_in)),
            np.asarray(alpha_c))

    tables = (torch.cat([t.float().reshape(1, -1)
                         for t in tt.sep_forms()[1]])
              if tabs else torch.empty((0, d)))
    calls = hmc_separable_step_plain.calls
    got = hmc_separable_step(
        tt, torch.from_numpy(pos), torch.from_numpy(logp_in),
        torch.tensor([eps]), n_leapfrog, 0, 0, tables,
        mom=torch.from_numpy(mom), u=torch.from_numpy(u))
    assert hmc_separable_step_plain.calls == calls + 1  # CPU: the twin
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)
    acc = np.asarray(accept)
    assert acc.any() and not acc.all()
    if case == "truncated":
        assert np.isnan(np.asarray(pos_p)[0]).any()
        assert np.isneginf(np.asarray(logp_prop)[1])
        assert not acc[:2].any() and (want[2][:2] == 0.0).all()
        np.testing.assert_array_equal(got[0][:2].numpy(), pos[:2])


def test_fused_twin_draws_are_keyed_by_place():
    """The fused twin's momenta are the trajectory's paired stream and its
    uniforms word x of (chain, step, 0, 1): drawn or given, the same
    step; a launch over a block of chains (``chain0``) is that block's
    rows of the whole launch; another step draws anew."""
    t = mt.standard_normal()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (12, 30)).astype(np.float32))
    lp = t.batch_logp(x)
    eps, tables = torch.tensor([0.2]), torch.empty((0, 30))
    drawn = hmc_separable_step(t, x, lp, eps, 5, 91, 4, tables)
    u = accept_uniforms(12, 4, 91)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u <= 1)).all())
    k0, k1 = rng.seed_words(91)
    w = rng.philox4x32_10(torch.arange(12), 4, 0, 1, (k0, k1))[0]
    assert torch.equal(u, rng.unit_open(w))
    given = hmc_separable_step(t, x, lp, eps, 5, 91, 4, tables,
                               mom=rng.paired_normals(12, 30, 4, 91), u=u)
    for a, b in zip(drawn, given):
        assert torch.equal(a, b)
    half = hmc_separable_step(t, x[6:], lp[6:], eps, 5, 91, 4, tables,
                              chain0=6)
    for a, b in zip(half, drawn):
        assert torch.equal(a, b[6:])
    other = hmc_separable_step(t, x, lp, eps, 5, 91, 5, tables)
    assert not torch.equal(other[0], drawn[0])
    # alpha_c is each chain's acceptance probability
    assert bool(((drawn[2] >= 0) & (drawn[2] <= 1)).all())


def _gates(sample_tm, n, c):
    """bench.py:635-640 on a time-major cube."""
    m, v = float(sample_tm.mean()), float(sample_tm.var(unbiased=False))
    rhat, ess = mt.split_rhat_mean_ess(sample_tm, time_major=True)
    assert abs(m) < 0.02, m
    assert abs(v - 1.0) < 0.05, v
    assert 0.95 <= float(rhat.mean()) <= 1.05, rhat.mean()
    assert float(ess.mean()) >= 0.02 * c * n, ess.mean()


def test_separable_tier_state_and_moment_gates():
    c, d, n = 256, 64, 128
    s = mt.HMC(mt.standard_normal(), mt.init_with_seed(c, d, seed=2,
                                                       device="cpu"),
               0.1, 10, use_pallas="separable", device="cpu").seed(2)
    assert isinstance(s.state, HMCSepState) and not hasattr(s.state, "grad")
    assert s.state.logp.dtype == torch.float32
    calls = hmc_separable_plain.calls
    s.run(n, n, time_major=True)
    sample = s.run(n, n, time_major=True)
    assert hmc_separable_plain.calls == calls + 4 * n  # one per step
    assert sample.shape == (n, c, d) and torch.isfinite(sample).all()
    _gates(sample, n, c)
    # the cached logp is the density at the positions
    np.testing.assert_allclose(
        s.state.logp.numpy(),
        mt.standard_normal().batch_logp(s.positions).numpy(), rtol=1e-5)


def test_separable_tier_seeding_layouts_and_python_targets():
    init = mt.init_with_seed(16, 12, seed=4, device="cpu")

    def make(seed=3, target=None, k=1):
        return mt.HMC(target or mt.standard_normal(), init, 0.2, 5,
                      use_pallas="separable", steps_per_call=k,
                      device="cpu").seed(seed)

    cm = make().run(16, 8)
    assert cm.shape == (16, 16, 12)
    assert torch.equal(make().run(16, 8, time_major=True).transpose(0, 1),
                       cm)
    assert torch.equal(make(k=4).run(16, 8), cm)
    assert not torch.equal(make(4).run(16, 8), cm)
    # a separable target with no coordinate functor runs on CPU tensors
    python_only = Target(logp=mt.standard_normal().logp)
    assert torch.equal(make(target=python_only).run(16, 8), cm)
    # step_eps returns the mean acceptance probability, as JAX's does
    s = make()
    from mini_mcmc_torch.ops.hmc import hmc_kernel
    _, step_fn = hmc_kernel(mt.standard_normal(), 0.2, 5,
                            use_pallas="separable")
    state, alpha = step_fn.step_eps(s.state, s._next_key(), 0.2)
    assert isinstance(state, HMCSepState) and 0.0 < float(alpha) <= 1.0


def test_start_state_carries_over_through_convert():
    c, d = 16, 8
    x = np.random.default_rng(6).standard_normal((c, d)).astype(np.float32)
    j = jmt.HMC(jm.standard_normal(), jnp.asarray(x), 0.1, 5,
                use_pallas="separable")
    kwargs = sampler_kwargs(j)
    assert kwargs == dict(step_size=0.1, n_leapfrog=5, use_pallas="separable",
                          jitter=0.0, steps_per_call=1, validate_dc=True)
    port = mt.HMC(mt.standard_normal(), x, **kwargs, device="cpu")
    carried = hmc_sep_state_from_numpy(*(np.asarray(v) for v in j.state),
                                       device="cpu")
    assert isinstance(carried, HMCSepState)
    for a, b in zip(state_to_numpy(port.state), state_to_numpy(carried)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    port.state = carried
    assert port.run(4).shape == (c, 4, d)
