"""The hand-written CUDA kernels against their plain PyTorch twins, on a
CUDA device. Marked ``cuda`` and skipped without one. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-3, atol 1e-4 (the kernel contracts multiply-adds into
FMAs; the twin rounds each operation), on short trajectories from states
near the Rosenbrock mode, where rounding differences do not grow. The
NUTS kernels make discrete choices (slice counts, U-turns, accepts) on
float comparisons that one ulp can flip, so they are held per chain: the
same choices and values within tolerance on at least 99.9% of chains,
all fields on chains whose subtree continues (``s``), the accumulators on
every chain. The MH and Gibbs kernels likewise: the same accepts (or z
draws) and values within rtol 1e-5 / atol 1e-6 on at least 99.9% of
chains, integer positions equal. The separable kernel (Kernel 7) is held
per chain against the float64 twin on the same momentum draws, its three
sums at rtol 1e-5, and its draws must not move with the launch grid; its
fused step makes the float64 twin's accept decision on at least 99.9% of
chains, in every layout (clusters up to the 16-tile limit, on two
streams at once) and in the two-pass form past the limit, with the positions per chain against float64; the
tempering kernel (Kernel 8) must equal its twin (positions, logp, swap
EWMA, history) on at least 99.9% of chains. Kernel 1's float64 instances
are held to the float64 twin per chain at 1e-9 of the row's largest
entry (every chain, L = 8); Kernel 5's int32 user instances to theirs
with int32 positions equal, the copies of built-ins bit for bit; a
float64 state on any other fused tier raises at construction. Kernels 4,
5 and 6 must give
bit-identical results under any launch grid, block of steps or chain
split, and Kernel 4 on two streams at once. The whitened instances of
Kernels 1-4 (a metric, ``csrc/targets.cuh:Whitened``) are held to their
twins on the whitened target as the plain instances are, and with
``L = I`` equal the plain instances bit for bit; Kernel 7's scaled
instances (a diagonal metric, ``csrc/coord_targets.cuh:Scaled``) as its
plain ones, on the float4 and the scalar path. MALA's ``"full"`` blocks
are Kernel 2 at L = 1, held to its twin per chain, and ``tuned`` leaves a
finite step size on every tier. The transformed instances of Kernels 5
and 8 (``transform=``) are held to their twins per chain as the plain
ones; ChEES-HMC, the ensemble, slice and elliptical samplers (no kernel)
run on the card by default, and ChEES-HMC's ``run()`` reads nothing from
the device. AIS and SMC (8,192 particles) and SGLD, pSGLD and SGHMC (1,024
chains) run on the card by default, pass bench.py's analytic gates there,
honour ``device="cpu"``, and an anneal or an SG-MCMC run reads nothing
from the device.
"""

import io
import math

import numpy as np
import pytest
import torch

from mini_mcmc_torch import (
    HMC,
    MALA,
    NUTS,
    SGHMC,
    SGLD,
    ChEESHMC,
    EllipticalSliceSampler,
    EnsembleSampler,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    SliceSampler,
    RunStats,
    ais_log_z,
    geometric_betas,
    minibatch_grad,
    polynomial_decay,
    smc_log_z,
    split_rhat_mean_ess,
    standard_normal,
    stats,
    summary,
    target_grad,
)
from mini_mcmc_torch.diagnostics import _quantile
from mini_mcmc_torch.models import (
    Preconditioner,
    Proposal,
    Target,
    constant_conditional,
    diffable_gaussian2d,
    gaussian2d,
    gaussian_mixture_conditional,
    isotropic_gaussian_proposal,
    isotropic_gaussian_target,
    poisson_target,
    precondition_target,
    random_walk_int_proposal,
    rosenbrock2d,
    rosenbrock_nd,
)
from mini_mcmc_torch.ops import make_anneal
from mini_mcmc_torch.ops.kernels import _build, rng
from mini_mcmc_torch.ops.kernels.gibbs_full import (
    gibbs_multistep,
    gibbs_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.mh_full import (
    mh_multistep,
    mh_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_sep import (
    accept_uniforms,
    hmc_separable,
    hmc_separable_plain,
    hmc_separable_step,
    hmc_separable_step_plain,
    sep_fused,
    sep_tiles,
)
from mini_mcmc_torch.ops.kernels.nuts_full import nuts_step, nuts_step_plain
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree, subtree_plain
from mini_mcmc_torch.ops.kernels.pt_full import (
    make_ladder,
    pt_multistep,
    pt_multistep_plain,
)

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def _state(c, d, seed):
    g = np.random.default_rng(seed)
    pos = (g.standard_normal((c, d)) * 0.3 + 0.9).astype(np.float32)
    mom = g.standard_normal((c, d)).astype(np.float32)
    return pos, mom


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; on the GPU run python "
                    "-m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_philox_bits_equal_plain(cuda):
    got = rng.philox_fill(1 << 16, 3, 1, 0xFEEDFACECAFEBEEF, cuda)
    want = rng.philox_fill_plain(1 << 16, 3, 1, 0xFEEDFACECAFEBEEF, cuda)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4])
def test_cuda_leapfrog_matches_plain(cuda, d):
    pos, mom = _state(4096, d, seed=d)
    t = rosenbrock_nd()
    x, m = torch.from_numpy(pos).to(cuda), torch.from_numpy(mom).to(cuda)
    _, g = t.batch_logp_and_grad(x)
    eps = torch.tensor([0.01], device=cuda)
    n = leapfrog_trajectory.launches
    got = leapfrog_trajectory(t, x, m, g, eps, 8)
    assert leapfrog_trajectory.launches == n + 1
    want = leapfrog_trajectory_plain(t, x, m, g, eps[0], 8)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
def test_cuda_multistep_matches_plain(cuda):
    pos, _ = _state(4096, 3, seed=9)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos).to(cuda)
    lp, g = t.batch_logp_and_grad(x)
    eps = torch.full((4,), 0.01, device=cuda)
    hk = torch.empty((4, 4096, 3), device=cuda)
    hp = torch.empty_like(hk)
    n = hmc_multistep.launches
    pk, lk, gk = hmc_multistep(t, x, lp, g, eps, 6, 1234, 0, hk)
    assert hmc_multistep.launches == n + 1
    pp, lpp, gp = hmc_multistep_plain(t, x, lp, g, eps, 6, 1234, 0, hp)

    def near(a, b, atol=ATOL):
        return (a - b).abs() <= atol + RTOL * b.abs()

    # the gradient's atol is scaled to the chain's largest |g|, as in
    # test_torch_models: x_{i+1} - x_i^2 cancels near a component's zero
    g_atol = ATOL + RTOL * gp.abs().amax(dim=1, keepdim=True)
    agree = near(hk, hp).all(2).all(0) & near(pk, pp).all(1)
    agree &= near(lk, lpp) & near(gk, gp, g_atol).all(1)
    assert float(agree.float().mean()) >= 0.999
    # the returned logp and grad are the density at the returned position
    lk_want, gk_want = t.batch_logp_and_grad(pk)
    _close(lk, lk_want)
    np.testing.assert_allclose(
        gk.cpu().numpy(), gk_want.cpu().numpy(), rtol=RTOL,
        atol=ATOL + RTOL * float(gk_want.abs().max()))


@pytest.mark.cuda
def test_cuda_target_without_functor_raises(cuda):
    """A target without a functor runs Kernels 1 and 2 through the C++
    generated from its batch form; one whose batch form the generator
    cannot translate raises at construction, naming the operation."""
    plain_target = Target(logp=rosenbrock_nd().logp)
    x = torch.ones((128, 3), device=cuda)
    for tier in ("full", True):
        launches = (hmc_multistep.user_launches,
                    leapfrog_trajectory.user_launches)
        out = HMC(plain_target, x, 0.02, 4, use_pallas=tier).seed(1).run(2)
        assert torch.isfinite(out).all()
        assert (hmc_multistep.user_launches,
                leapfrog_trajectory.user_launches) != launches
    untraceable = Target(logp=lambda p: -torch.sigmoid(p).sum(-1))
    with pytest.raises(ValueError, match="sigmoid.*cuda_source"):
        HMC(untraceable, x, 0.02, 4, use_pallas="full")
    with pytest.raises(ValueError, match="sigmoid"):
        HMC(untraceable, x, 0.02, 4, use_pallas=True)
    HMC(untraceable, x, 0.02, 4).run(2)  # the plain tier needs no C++


def _nuts_state(c, seed):
    """A subtree call on the Gaussian from states near the mode."""
    g = np.random.default_rng(seed)
    pos = (g.standard_normal((c, 2)) * 1.5 + [0.0, 1.0]).astype(np.float32)
    mom = g.standard_normal((c, 2)).astype(np.float32)
    eps = g.uniform(0.3, 1.2, c).astype(np.float32)
    return pos, mom, eps


def _share(ok):
    return float(ok.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "j, mask, cut", [(0, None, 0), (2, None, 0), (4, None, 0), (5, None, 0),
                     (10, None, 0), (4, True, 0), (4, False, 0),
                     (5, None, 5), (10, None, 10)],
    ids=["0", "2", "4", "5", "10", "4-all-active", "4-none-active",
         "5-all-leaves", "10-all-leaves"])
def test_cuda_subtree_matches_plain(cuda, j, mask, cut):
    # cut: steps divided by 2^cut, so that most chains run all 2^j leaves
    # (every row of the U-turn stack, every merge of the cascade)
    c = 8192
    pos, mom, eps = _nuts_state(c, seed=20 + j)
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x, m = torch.from_numpy(pos).to(cuda), torch.from_numpy(mom).to(cuda)
    e = torch.from_numpy(eps / np.float32(2 ** cut)).to(cuda)
    lp, g = t.batch_logp_and_grad(x)
    joint0 = lp - 0.5 * (m * m).sum(1)
    gen = torch.Generator(device=cuda).manual_seed(j)
    logu = joint0 - torch.empty(c, device=cuda).exponential_(generator=gen)
    v = torch.where(torch.rand(c, generator=gen, device=cuda) < 0.5, -1,
                    1).to(torch.int32)
    active = torch.rand(c, generator=gen, device=cuda) < 0.75
    if mask is not None:
        active = torch.full((c,), mask, device=cuda)
    args = (t, x, m, g, logu, v, j, e, joint0, active, (12345, -6789), 10)
    n = subtree.launches
    got = subtree(*args)
    assert subtree.launches == n + 1
    want = subtree_plain(*args)
    torch.cuda.synchronize()
    same = ((got.n == want.n) & (got.s == want.s)
            & (got.n_alpha == want.n_alpha) & (got.diverged == want.diverged))
    for part in (active, ~active):  # counts and flags, active or not
        if part.any():
            assert _share(same[part]) >= 0.999
    if mask is False:
        for k in ("n", "alpha", "n_alpha", "diverged"):
            assert not getattr(got, k).any(), k
    near = (got.alpha - want.alpha).abs() <= ATOL + RTOL * want.alpha.abs()
    assert _share(same & near) >= 0.999
    s = same & want.s
    full = (want.n_alpha == 1 << j) & want.s & active
    if cut:
        assert _share(full) >= 0.5
    for a, b in zip(got[:6], want[:6]):
        ok = ((a - b).abs() <= ATOL + RTOL * b.abs())
        ok = ok.reshape(c, -1).all(1) | ~s
        assert _share(ok) >= 0.999
        if cut:
            assert _share(ok[full] & same[full]) >= 0.999


@pytest.mark.cuda
def test_cuda_nuts_step_matches_plain(cuda):
    c = 8192
    pos, _, eps = _nuts_state(c, seed=30)
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x = torch.from_numpy(pos).to(cuda)
    e = torch.from_numpy(eps).to(cuda)
    n = nuts_step.launches
    got = nuts_step(t, x, e, 10, 0xC0FFEE, 17, 10)
    assert nuts_step.launches == n + 1
    want = nuts_step_plain(t, x, e, 10, 0xC0FFEE, 17, 10)
    torch.cuda.synchronize()
    same_pos = (got[0] - want[0]).abs().le(ATOL + RTOL * want[0].abs()).all(1)
    assert _share(same_pos) >= 0.999
    for a, b in zip(got[1:4], want[1:4]):
        assert _share((a - b).abs() <= ATOL + RTOL * b.abs()) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999  # each chain's own depth
    assert int(got[4].max()) >= 2


@pytest.mark.cuda
def test_cuda_nuts_step_is_the_same_under_any_grid(cuda):
    # warps take chains from a counter in no fixed order; each chain's
    # result depends on (key, step, chain) alone, so the occupancy-sized
    # grid and a single block agree bit for bit
    c = 8192
    pos, _, eps = _nuts_state(c, seed=31)
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x = torch.from_numpy(pos).to(cuda)
    e = torch.from_numpy(eps).to(cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    grid = {}
    full = nuts_step(t, x, e, 10, 0xC0FFEE, 17, 10, stats=stats, grid=grid)
    assert grid["blocks"] == min(grid["blocks_per_sm"] * grid["sms"],
                                 c // 128)
    for blocks in (1, 3):
        other = nuts_step(t, x, e, 10, 0xC0FFEE, 17, 10, blocks=blocks)
        for a, b in zip(full, other):
            assert torch.equal(a, b), blocks
    # every leaf ran on a thread; a lane-iteration integrates at most one
    details = {}
    nuts_step_plain(t, x, e, 10, 0xC0FFEE, 17, 10, details=details)
    lane_iterations, leaves = (int(v) for v in stats.cpu())
    assert abs(leaves - int(details["leaves"].sum())) <= 0.001 * leaves
    assert leaves <= lane_iterations


@pytest.mark.cuda
def test_cuda_nuts_step_on_two_streams_at_once(cuda):
    # each stream takes its own chain counter: two launches in flight on
    # two streams, each on its own chains and small enough grids to run
    # side by side, give the single-stream results bit for bit
    c = 8192
    pos, _, eps = _nuts_state(c, seed=32)
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x = torch.from_numpy(pos).to(cuda)
    e = torch.from_numpy(eps).to(cuda)
    halves = (slice(0, c // 2), slice(c // 2, c))
    args = [(t, x[sl], e[sl], 10, 0xC0FFEE, 17, 10, sl.start)
            for sl in halves]
    want = [nuts_step(*a, blocks=8) for a in args]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda))
    got = []
    for _ in range(4):
        for a, stream in zip(args, streams):
            with torch.cuda.stream(stream):
                got.append(nuts_step(*a, blocks=8))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        for a, b in zip(out, want[i % 2]):
            assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, "full"])
def test_cuda_nuts_tiers_pass_the_gates(cuda, use_pallas):
    # bench.py:321-336's gates at 1,024 chains, loosened for the size as
    # tests/test_torch_nuts.py loosens them
    mean, cov = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
    x = np.random.default_rng(7).standard_normal((1024, 2)).astype(
        np.float32)
    s = NUTS(diffable_gaussian2d(mean, cov), torch.from_numpy(x).to(cuda),
             0.8, use_pallas=use_pallas).seed(7)
    s.run(64, 64)
    sample = s.run(160, 0)
    assert sample.is_cuda and torch.isfinite(sample).all()
    rhat, ess = split_rhat_mean_ess(sample)
    assert 0.95 <= float(rhat.mean()) <= 1.05
    assert float(ess.min()) >= 0.005 * 1024 * 160
    m = sample.double().mean(dim=(0, 1))
    v = sample.double().var(dim=(0, 1), unbiased=False)
    for d in range(2):
        assert abs(float(m[d]) - mean[d]) <= 0.15, m
        assert abs(float(v[d]) - cov[d][d]) <= 0.5, v
    assert int(s.last_run_divergences.sum()) <= 1


@pytest.mark.cuda
def test_cuda_nuts_philox_draws_equal_plain(cuda):
    # the counters of the new draw layout: merges at draw 0x10000 + j with
    # sub-draws, and the subtree seeds at 0x20000 + j
    key = 0xFEEDFACECAFEBEEF
    for c1, c2 in ((5, 0x10000 + 3), (5, 0x20000 + 1), (2**32 - 1, 2)):
        got = rng.philox_fill(1 << 16, c1, c2, key, cuda)
        want = rng.philox_fill_plain(1 << 16, c1, c2, key, cuda)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_nuts_full_raises_without_functor_or_f32(cuda):
    x = torch.zeros((256, 2), device=cuda)
    plain = Target(logp=diffable_gaussian2d([0.0, 0.0],
                                            [[1.0, 0.0], [0.0, 1.0]]).logp)
    for tier in ("full", True):  # the C++ generated from the batch form
        out = NUTS(plain, x, 0.8, use_pallas=tier).seed(1).run(4, 4)
        assert torch.isfinite(out).all()
    untraceable = Target(logp=lambda p: -torch.cumsum(p, -1).sum(-1))
    with pytest.raises(ValueError, match="cumsum"):
        NUTS(untraceable, x, 0.8, use_pallas="full")
    with pytest.raises(ValueError, match="cumsum"):
        NUTS(untraceable, x, 0.8, use_pallas=True)
    g = diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(ValueError, match="float32"):
        NUTS(g, x.double(), 0.8, use_pallas="full")
    with pytest.raises(ValueError, match="max_depth"):
        NUTS(g, x, 0.8, max_depth=12, use_pallas="full")
    out = NUTS(g, x, 0.8, use_pallas="full").seed(1).run(8, 8)
    assert out.is_cuda and torch.isfinite(out).all()


MIX = (-2.0, 1.0, 3.0, 1.5, 0.5)


def _near(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs() <= 1e-6 + 1e-5 * b.abs()) | (a == b)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gauss2d", "rosenbrock2", "rosenbrock3",
                                   "poisson"])
def test_cuda_mh_multistep_matches_plain(cuda, which):
    c, k = 8192, 16
    g = np.random.default_rng(40)
    if which == "gauss2d":
        t = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
        p = isotropic_gaussian_proposal(1.0)
        x = torch.from_numpy(g.standard_normal((c, 2)).astype(np.float32))
    elif which.startswith("rosenbrock"):
        # the reference's rosenbrock_mh example samples D = 2
        t, p = rosenbrock_nd(), isotropic_gaussian_proposal(0.1)
        x = torch.from_numpy(_state(c, int(which[-1]), seed=40)[0])
    else:
        t, p = poisson_target(4.0), random_walk_int_proposal()
        x = torch.from_numpy(g.integers(0, 10, (c, 1)).astype(np.int32))
    x = x.to(cuda)
    lp = t.batch_logp(x)
    hk = torch.empty((k,) + tuple(x.shape), dtype=x.dtype, device=cuda)
    hp = torch.empty_like(hk)
    n = mh_multistep.launches
    pk, lk = mh_multistep(t, p, x, lp, 0xFACE, 3, k, hk)
    assert mh_multistep.launches == n + 1
    pp, lpp = mh_multistep_plain(t, p, x, lp, 0xFACE, 3, k, hp)
    torch.cuda.synchronize()
    assert pk.dtype == x.dtype and lk.dtype == torch.float32
    agree = _near(hk, hp).all(2).all(0) & _near(pk, pp).all(1)
    agree &= _near(lk, lpp)
    assert _share(agree) >= 0.999
    if which == "poisson":
        assert _share((hk == hp).all(2).all(0)) >= 0.999
    moved = (hk[1:] != hk[:-1]).any(2)
    assert 0.1 < _share(moved) < 0.95


@pytest.mark.cuda
def test_cuda_gibbs_multistep_matches_plain(cuda):
    c, k = 8192, 32
    g = np.random.default_rng(41)
    x = np.stack([g.normal(0.5, 3.0, c), g.integers(0, 2, c)], axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    cond = gaussian_mixture_conditional(*MIX)
    hk = torch.empty((k, c, 2), device=cuda)
    hp = torch.empty_like(hk)
    n = gibbs_multistep.launches
    out = gibbs_multistep(cond, x, 0xD1CE, 5, k, hk)
    assert gibbs_multistep.launches == n + 1
    want = gibbs_multistep_plain(cond, x, 0xD1CE, 5, k, hp)
    torch.cuda.synchronize()
    x_ok = _near(hk[..., 0], hp[..., 0]).all(0) & _near(out[:, 0],
                                                        want[:, 0])
    z_ok = (hk[..., 1] == hp[..., 1]).all(0)
    assert _share(x_ok & z_ok) >= 0.999
    assert 0.3 < float(hk[..., 1].mean()) < 0.7


@pytest.mark.cuda
def test_cuda_mh_gibbs_philox_draws_equal_plain(cuda):
    # the MH and Gibbs word stream: the counters (chain, step, q, 0) for
    # q < ceil(W / 4), word 4q + j being word j of evaluation q; at steps
    # past 2**31 and at the largest step
    key = 0x0DDBA11CAFE
    n = 1 << 16
    for step, n_words in ((2**31 + 5, 3), (7, 5), (7, 2), (2**32 - 1, 3)):
        want = rng.stream_words(n, n_words, step, key, cuda)
        assert want.shape == (n, 4 * ((n_words + 3) // 4))
        for q in range((n_words + 3) // 4):
            got = rng.philox_fill(n, step, q, key, cuda)
            assert torch.equal(got, want[:, 4 * q:4 * q + 4])


def _k56_case(which, c, cuda):
    """(kernel, twin, leading args, state) of a Kernel 5 or 6 instance."""
    g = np.random.default_rng(42)
    if which == "gibbs":
        x = np.stack([g.normal(0.5, 3.0, c), g.integers(0, 2, c)], axis=1)
        x = torch.from_numpy(x.astype(np.float32)).to(cuda)
        return (gibbs_multistep, gibbs_multistep_plain,
                (gaussian_mixture_conditional(*MIX),), (x,))
    if which == "poisson":
        t, p = poisson_target(4.0), random_walk_int_proposal()
        x = torch.from_numpy(g.integers(0, 10, (c, 1)).astype(np.int32))
    elif which == "gauss2d":
        t = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
        p = isotropic_gaussian_proposal(1.0)
        x = torch.from_numpy(g.standard_normal((c, 2)).astype(np.float32))
    else:
        t, p = rosenbrock_nd(), isotropic_gaussian_proposal(0.1)
        x = torch.from_numpy(_state(c, 3, seed=42)[0])
    x = x.to(cuda)
    return mh_multistep, mh_multistep_plain, (t, p), (x, t.batch_logp(x))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gauss2d", "rosenbrock3", "poisson",
                                   "gibbs"])
def test_cuda_k_step_launch_equals_one_step_launches(cuda, which):
    # draws depend on (key, chain, global step) alone: a K-step launch, K
    # one-step launches and a launch per half of the chains give the same
    # history and state bit for bit
    c, k, seed = 8192, 16, 0xBADC0DE
    kernel, _, lead, state = _k56_case(which, c, cuda)
    shape = (k,) + tuple(state[0].shape)
    one = torch.empty(shape, dtype=state[0].dtype, device=cuda)
    out = kernel(*lead, *state, seed, 3, k, one)
    steps = torch.empty_like(one)
    s = state
    for i in range(k):
        s = kernel(*lead, *s, seed, 3 + i, 1, steps[i:i + 1])
        s = s if isinstance(s, tuple) else (s,)
    halves = torch.empty_like(one)
    h = [kernel(*lead, *(v[sl] for v in state), seed, 3, k, halves[:, sl],
                chain0=sl.start) for sl in (slice(0, c // 2),
                                            slice(c // 2, c))]
    torch.cuda.synchronize()
    assert torch.equal(one, steps) and torch.equal(one, halves)
    out = out if isinstance(out, tuple) else (out,)
    h = [v if isinstance(v, tuple) else (v,) for v in h]
    for a, b, c1, c2 in zip(out, s, *h):
        assert torch.equal(a, b) and torch.equal(a, torch.cat([c1, c2]))
    assert (one[1:] != one[:-1]).any()


@pytest.mark.cuda
def test_cuda_mh_gibbs_functor_and_dtype_errors(cuda):
    t = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    walk = isotropic_gaussian_proposal(1.0)
    x = torch.zeros((256, 2), device=cuda)
    with pytest.raises(ValueError, match="float32, D=2"):
        MetropolisHastings(t, walk, x.double(), use_pallas="full")
    # a user density runs in its own library, float32 or int32 states
    with pytest.raises(ValueError, match="does not take float64"):
        MetropolisHastings(Target(logp=t.logp), walk, x.double(),
                           use_pallas="full")
    no_form = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True)
    with pytest.raises(ValueError, match="propose_words"):
        MetropolisHastings(t, no_form, x, use_pallas="full")
    with pytest.raises(ValueError, match="random_walk_int, int32"):
        MetropolisHastings(poisson_target(4.0), walk,
                           torch.zeros((256, 1), device=cuda),
                           use_pallas="full")
    cond = gaussian_mixture_conditional(*MIX)
    with pytest.raises(ValueError, match="float32"):
        GibbsSampler(cond, x.double(), use_pallas="full")
    with pytest.raises(ValueError, match="sample_words"):
        GibbsSampler(constant_conditional(1.0), x, use_pallas="full")
    with pytest.raises(ValueError, match="D=2"):
        GibbsSampler(cond, torch.zeros((256, 3), device=cuda),
                     use_pallas="full")
    # the plain tiers need no CUDA form, and the fused ones run
    assert MetropolisHastings(t, no_form, x).run(4).is_cuda
    out = MetropolisHastings(poisson_target(4.0), random_walk_int_proposal(),
                             torch.zeros((256, 1), dtype=torch.int32,
                                         device=cuda), use_pallas="full",
                             steps_per_call=4).seed(1).run(8, 4)
    assert out.dtype == torch.int32 and int(out.min()) >= 0
    out = GibbsSampler(cond, x, use_pallas="full", steps_per_call=4).seed(
        1).run(8, 4)
    assert torch.isfinite(out).all()


def _sigma_target(sigma: torch.Tensor) -> Target:
    def tile(x, s):
        return torch.sum(-0.5 * (x / s.to(x.dtype)) ** 2, dim=-1)

    return Target(logp=lambda x: tile(x, sigma), sep_form=(tile, (sigma,)),
                  cuda_functor="sigma_table_normal")


@pytest.mark.cuda
@pytest.mark.parametrize("which,d", [("standard_normal", 1000),
                                     ("isotropic_gaussian", 37),
                                     ("sigma_table", 1002)])
def test_cuda_separable_matches_plain(cuda, which, d):
    c, n_leapfrog, seed, step = 512, 10, 0x5EED_77, 3
    g = np.random.default_rng(50)
    x = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    x = x.to(cuda)
    if which == "standard_normal":
        t = standard_normal()
    elif which == "isotropic_gaussian":
        t = isotropic_gaussian_target(1.5)
    else:
        t = _sigma_target(torch.from_numpy(
            (0.5 + g.random(d)).astype(np.float32)).to(cuda))
    tables = (torch.cat([s.reshape(1, -1) for s in t.sep_forms()[1]])
              if t.sep_form else torch.empty((0, d), device=cuda))
    eps = torch.tensor([0.1], device=cuda)
    n = hmc_separable.launches
    got = hmc_separable(t, x, eps, n_leapfrog, seed, step, tables)
    assert hmc_separable.launches == n + 1
    want = hmc_separable_plain(t, x, eps, n_leapfrog, seed, step, tables)
    ref = hmc_separable_plain(t, x.double(), eps.double(), n_leapfrog, seed,
                              step, tables.double())
    torch.cuda.synchronize()
    for a, b in zip(got[:4], want[:4]):
        _close(a, b)
    for a, b in zip(got[1:4], ref[1:4]):  # the sums, against float64
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    near = (got[0] - ref[0]).abs() <= ATOL + RTOL * ref[0].abs()
    assert _share(near.all(1)) >= 0.999
    # the draws do not move with the launch grid: 4x the D-tiles
    small = hmc_separable(t, x, eps, n_leapfrog, seed, step, tables,
                          threads=64)
    assert torch.equal(small[0], got[0])
    for a, b in zip(small[1:4], got[1:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    # the debug form, the drawn momentum given as input
    mom = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    mom = mom.to(cuda)
    k = hmc_separable(t, x, eps, n_leapfrog, seed, step, tables, mom)
    p = hmc_separable_plain(t, x, eps, n_leapfrog, seed, step, tables, mom)
    for a, b in zip(k, p):
        _close(a, b)


@pytest.mark.cuda
def test_cuda_separable_sampler(cuda):
    x = torch.randn((256, 64), device=cuda)
    # a plain target runs the coordinate functor generated from its batch
    # form; a tile form of three tables raises, naming the limit
    n = hmc_separable_step.user_launches
    plain = HMC(Target(logp=standard_normal().logp), x, 0.1, 5,
                use_pallas="separable").seed(1).run(4)
    assert hmc_separable_step.user_launches == n + 4
    assert bool(torch.isfinite(plain).all())
    ones = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="at most 2"):
        HMC(Target(logp=standard_normal().logp,
                   sep_form=(lambda v, a, b, c: -0.5 * torch.sum(
                       v * v * a * b * c, -1), (ones, ones, ones))),
            x, 0.1, 5, use_pallas="separable")
    with pytest.raises(ValueError, match="separable"):
        HMC(rosenbrock_nd(), torch.randn((64, 3), device=cuda), 0.1, 5,
            use_pallas="separable")
    with pytest.raises(ValueError, match="float32"):
        HMC(standard_normal(), x.double(), 0.1, 5, use_pallas="separable")
    # validation runs where the positions lie: a table on the card works
    sigma = torch.linspace(0.5, 2.0, 64, device=cuda)
    HMC(_sigma_target(sigma), x, 0.1, 5, use_pallas="separable")
    with pytest.raises(ValueError, match="separable"):
        HMC(Target(logp=_sigma_target(sigma).logp,
                   sep_form=(lambda x, s: _sigma_target(sigma).logp(x),
                             (sigma,)), cuda_functor="sigma_table_normal"),
            x, 0.1, 5, use_pallas="separable")
    n, n2 = hmc_separable_step.launches, hmc_separable.launches
    out = HMC(standard_normal(), x, 0.2, 8, use_pallas="separable",
              steps_per_call=4).seed(2).run(32, 32)
    # one fused launch a step, no two-pass launch
    assert hmc_separable_step.launches == n + 64
    assert hmc_separable.launches == n2
    assert out.is_cuda and torch.isfinite(out).all()
    assert abs(float(out.var()) - 1.0) < 0.1


W_PLUS = 0.7


def _mixture() -> Target:
    lw0, lw1 = math.log(1 - W_PLUS), math.log(W_PLUS)

    def logp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                  cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("which,n_temps,n_inner,c", [
    ("mixture", 8, 1, 8192), ("mixture", 16, 2, 8192),
    ("gaussian2d", 4, 1, 8192), ("gaussian2d", 5, 2, 8192),
    ("mixture", 2, 1, 8192), ("mixture", 8, 1, 1000),
    ("gaussian2d", 16, 1, 1003)])
def test_cuda_pt_multistep_matches_plain(cuda, which, n_temps, n_inner, c):
    # T = 16 puts 2 chains in a warp, T = 5 leaves 3 of 8 lanes idle, and
    # 1000 or 1003 chains leave the last block short
    k = 16
    g = np.random.default_rng(60)
    if which == "mixture":
        t, d, std = _mixture(), 1, 1.0
        x = g.choice([-8.0, 8.0], (c, 1)) + 0.5 * g.standard_normal((c, 1))
    else:
        t = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
        d, std = 2, [1.0, 1.5]
        x = g.standard_normal((c, 2)) * 2.0
    betas = geometric_betas(n_temps, 0.01)
    pt = ParallelTempering(t, torch.from_numpy(x.astype(np.float32)),
                           betas=betas, proposal_std=std, n_inner=n_inner,
                           device=cuda)
    s = pt.state
    lad = make_ladder(betas, std, d, cuda)
    hk = torch.empty((k, c, d), device=cuda)
    hp = torch.empty_like(hk)
    args = (t, s.positions, s.raw_logp, s.swap_accept, 1, lad, 0xBEEF, 7,
            k, n_inner)
    n = pt_multistep.launches
    got = pt_multistep(*args, hk)
    assert pt_multistep.launches == n + 1
    want = pt_multistep_plain(*args, hp)
    torch.cuda.synchronize()
    same = (got[0] == want[0]).all(1).all(0) & (got[2] == want[2]).all(0)
    same &= (hk == hp).all(2).all(0)
    # the mixture functor rounds as the twin; the Gaussian's quadratic
    # contracts FMAs, so its logp agrees to an ulp
    lp_ok = ((got[1] == want[1]) if which == "mixture"
             else _near(got[1], want[1])).all(0)
    assert _share(same & lp_ok) >= 0.999
    moved = (hk[1:] != hk[:-1]).any(2)
    assert 0.05 < _share(moved) < 0.95
    assert float(got[2].mean()) > 0.0  # swaps happened


@pytest.mark.cuda
def test_cuda_pt_sampler_errors_and_runs(cuda):
    x = torch.full((1024, 1), -8.0, device=cuda)
    # a plain target runs its traced density (the value-only library); a
    # user density past D = 16 raises
    n = pt_multistep.user_launches
    ParallelTempering(Target(logp=_mixture().logp), x, use_pallas="full",
                      steps_per_call=4).seed(1).run(8)
    assert pt_multistep.user_launches == n + 2
    with pytest.raises(ValueError, match="D <= 16"):
        ParallelTempering(Target(logp=_mixture().logp),
                          torch.zeros((64, 17), device=cuda),
                          use_pallas="full")
    with pytest.raises(ValueError, match="at most 16"):
        ParallelTempering(_mixture(), x, betas=geometric_betas(17),
                          use_pallas="full")
    with pytest.raises(ValueError, match="D=3"):
        ParallelTempering(gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                          torch.zeros((64, 3), device=cuda),
                          use_pallas="full")
    with pytest.raises(ValueError, match="float32"):
        ParallelTempering(_mixture(), x.double(), use_pallas="full")
    n = pt_multistep.launches
    pt = ParallelTempering(_mixture(), x, betas=geometric_betas(8, 0.01),
                           use_pallas="full", steps_per_call=16).seed(5)
    out = pt.run(256, 256, time_major=True)
    assert pt_multistep.launches == n + 32
    # the kernel writes chain-major cubes through their strides too
    cm = ParallelTempering(_mixture(), x, betas=geometric_betas(8, 0.01),
                           use_pallas="full", steps_per_call=16).seed(5).run(
                               256, 256)
    assert torch.equal(cm.transpose(0, 1), out)
    assert out.is_cuda and out.shape == (256, 1024, 1)
    assert 0.5 < float((out > 0).float().mean()) < 0.9
    assert bool((pt.swap_acceptance > 0.05).all())
    # the plain tier needs no CUDA form
    plain = ParallelTempering(Target(logp=_mixture().logp), x,
                              betas=(1.0, 0.1)).seed(1).run(4)
    assert plain.is_cuda


# the (target, D) pairs of MM_DISPATCH, each whitened by a diagonal and a
# dense metric
WHITENED = [(name, d, kind) for name, d in (("rosenbrock", 2),
                                            ("rosenbrock", 3),
                                            ("rosenbrock", 4),
                                            ("gaussian2d", 2))
            for kind in ("diag", "dense")]
WHITENED_IDS = [f"{n}{d}-{k}" for n, d, k in WHITENED]


def _metric(d, kind, seed, scale=0.5):
    g = np.random.default_rng(seed)
    if kind == "diag":
        return Preconditioner("diag", scale=torch.from_numpy(
            g.uniform(0.6, 1.4, d).astype(np.float32) * scale))
    a = g.standard_normal((d, d))
    cov = (a @ a.T / d + np.eye(d)) * scale * scale
    return Preconditioner("dense", chol=torch.from_numpy(
        np.linalg.cholesky(cov).astype(np.float32)))


def _whitened(name, d, kind, c, cuda, seed):
    """A whitened target and y-space states near its mode: Rosenbrock
    states as _state's, Gaussian states as _nuts_state's."""
    if name == "rosenbrock":
        t, scale = rosenbrock_nd(), 0.4
        x = _state(c, d, seed)[0]
    else:
        t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
        scale, x = 1.8, _nuts_state(c, seed)[0]
    pre = _metric(d, kind, seed, scale).to(cuda)
    return precondition_target(t, pre), pre.to_y(torch.from_numpy(x).to(
        cuda)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name, d, kind", WHITENED, ids=WHITENED_IDS)
def test_cuda_whitened_leapfrog_and_multistep_match_plain(cuda, name, d,
                                                          kind):
    c = 4096
    t, y = _whitened(name, d, kind, c, cuda, seed=50 + d)
    assert t.cuda_affine
    m = torch.from_numpy(_state(c, d, seed=60 + d)[1]).to(cuda)
    lp, g = t.batch_logp_and_grad(y)
    eps = torch.tensor([0.01], device=cuda)
    got = leapfrog_trajectory(t, y, m, g, eps, 8)
    want = leapfrog_trajectory_plain(t, y, m, g, eps[0], 8)
    for a, b in zip(got, want):  # atol scaled as test_torch_models's
        a, b = a.reshape(c, -1), b.reshape(c, -1)
        scale = b.abs().amax(1, keepdim=True)
        ok = (a - b).abs() <= ATOL + RTOL * (b.abs() + scale)
        assert _share(ok.all(1)) >= 0.999
    ks = torch.full((4,), 0.01, device=cuda)
    hk = torch.empty((4, c, d), device=cuda)
    hp = torch.empty_like(hk)
    pk, lk, gk = hmc_multistep(t, y, lp, g, ks, 6, 1234, 0, hk)
    pp, lpp, gp = hmc_multistep_plain(t, y, lp, g, ks, 6, 1234, 0, hp)
    g_atol = ATOL + RTOL * gp.abs().amax(dim=1, keepdim=True)
    near = (hk - hp).abs() <= ATOL + RTOL * hp.abs()
    agree = near.all(2).all(0) & ((lk - lpp).abs() <= ATOL
                                  + RTOL * lpp.abs())
    agree &= ((gk - gp).abs() <= g_atol + RTOL * gp.abs()).all(1)
    assert _share(agree) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name, d, kind", WHITENED, ids=WHITENED_IDS)
def test_cuda_whitened_nuts_kernels_match_plain(cuda, name, d, kind):
    c, j = 8192, 4
    t, y = _whitened(name, d, kind, c, cuda, seed=70 + d)
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = torch.randn((c, d), generator=gen, device=cuda)
    lp, g = t.batch_logp_and_grad(y)
    eps = torch.full((c,), 0.02 if name == "rosenbrock" else 0.4,
                     device=cuda)
    joint0 = lp - 0.5 * (m * m).sum(1)
    logu = joint0 - torch.empty(c, device=cuda).exponential_(generator=gen)
    v = torch.where(torch.rand(c, generator=gen, device=cuda) < 0.5, -1,
                    1).to(torch.int32)
    active = torch.rand(c, generator=gen, device=cuda) < 0.75
    args = (t, y, m, g, logu, v, j, eps, joint0, active, (12345, -6789), 10)
    got, want = subtree(*args), subtree_plain(*args)
    same = ((got.n == want.n) & (got.s == want.s)
            & (got.n_alpha == want.n_alpha) & (got.diverged == want.diverged))
    for part in (active, ~active):
        assert _share(same[part]) >= 0.999
    s = same & want.s
    for a, b in zip(got[:6], want[:6]):
        ok = ((a - b).abs() <= ATOL + RTOL * b.abs()).reshape(c, -1).all(1)
        assert _share(ok | ~s) >= 0.999
    got = nuts_step(t, y, eps, 10, 0xC0FFEE, 17, 10)
    want = nuts_step_plain(t, y, eps, 10, 0xC0FFEE, 17, 10)
    same_pos = (got[0] - want[0]).abs().le(ATOL + RTOL * want[0].abs())
    assert _share(same_pos.all(1)) >= 0.999
    for a, b in zip(got[1:4], want[1:4]):
        assert _share((a - b).abs() <= ATOL + RTOL * b.abs()) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name, d", [("rosenbrock", 3), ("gaussian2d", 2)])
def test_cuda_identity_metric_equals_the_plain_instance(cuda, name, d):
    # L = I: x_i = 1 y_i plus zero terms and g_y = 1 g plus zero terms, so
    # the whitened instance repeats the unwhitened one bit for bit
    c = 4096
    inner = (rosenbrock_nd() if name == "rosenbrock" else
             diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]))
    eye = Preconditioner("dense", chol=torch.eye(d, device=cuda))
    w = precondition_target(inner, eye)
    assert w.cuda_params == (1.0, 0.0, 1.0, 0.0, 0.0, 1.0)[:d * (d + 1)
                                                           // 2] + tuple(
        inner.cuda_params)
    y = torch.from_numpy(_state(c, d, seed=81)[0]).to(cuda)
    m = torch.from_numpy(_state(c, d, seed=82)[1]).to(cuda)
    lp, g = inner.batch_logp_and_grad(y)
    eps1 = torch.tensor([0.01], device=cuda)
    eps = torch.full((c,), 0.02, device=cuda)
    for run in (
            lambda tt: leapfrog_trajectory(tt, y, m, g, eps1, 8),
            lambda tt: hmc_multistep(tt, y, lp, g, eps1.repeat(4), 6, 9, 0),
            lambda tt: nuts_step(tt, y, eps, 10, 0xC0FFEE, 17, 10),
            lambda tt: subtree(tt, y, m, g, lp - 2.0, torch.ones(
                c, dtype=torch.int32, device=cuda), 3, eps, lp,
                torch.ones(c, dtype=torch.bool, device=cuda), (1, 2), 10)):
        for a, b in zip(run(w), run(inner)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_nuts_step_sets_its_limit_on_every_launch(cuda):
    # Kernel 4 sets its dynamic shared-memory limit (a depth-10 stack, past
    # 48 KB a block at D = 4) on every launch, in the current device's
    # context. One card cannot show a second device's context: this runs a
    # launch, makes the same device current again, and launches again.
    c = 4096
    t, y = _whitened("rosenbrock", 4, "dense", c, cuda, seed=90)
    eps = torch.full((c,), 0.02, device=cuda)
    first = nuts_step(t, y, eps, 10, 0xC0FFEE, 17, 10)
    torch.cuda.set_device(cuda.index or 0)
    again = nuts_step(t, y, eps, 10, 0xC0FFEE, 17, 10)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [True, "full"])
def test_cuda_nuts_dense_metric_passes_the_gates(cuda, use_pallas):
    # bench.py:370-379's gates at 1,024 chains, loosened for the size as
    # test_cuda_nuts_tiers_pass_the_gates loosens bench.py:321-336's
    mean, cov = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
    x = np.random.default_rng(8).standard_normal((1024, 2)).astype(
        np.float32)
    s = NUTS(diffable_gaussian2d(mean, cov), torch.from_numpy(x).to(cuda),
             0.8, use_pallas=use_pallas).seed(8)
    s.run(64, 64)
    tuned = s.reconditioned("dense", seed=11)
    assert tuned.metric.chol.is_cuda and tuned.kernel_target.cuda_affine
    launches = (subtree if use_pallas is True else nuts_step).launches
    tuned.run(64, 64)
    sample = tuned.run(160, 0)
    assert (subtree if use_pallas is True else nuts_step).launches > launches
    assert sample.is_cuda and torch.isfinite(sample).all()
    rhat, ess = split_rhat_mean_ess(sample)
    assert 0.95 <= float(rhat.mean()) <= 1.05
    assert float(ess.min()) >= 0.01 * 1024 * 160
    m = sample.double().mean(dim=(0, 1))
    v = sample.double().var(dim=(0, 1), unbiased=False)
    for d in range(2):
        assert abs(float(m[d]) - mean[d]) <= 0.15, m
        assert abs(float(v[d]) - cov[d][d]) <= 0.5, v


@pytest.mark.cuda
def test_cuda_hmc_metric_tiers_and_separable_raises(cuda):
    x = torch.from_numpy(_state(2048, 3, seed=91)[0]).to(cuda)
    pre = _metric(3, "diag", 91, 0.4)
    for tier, kernel in ((True, leapfrog_trajectory),
                         ("full", hmc_multistep)):
        n = kernel.launches
        h = HMC(rosenbrock_nd(), x, 0.03, 16, use_pallas=tier, metric=pre,
                steps_per_call=4).seed(3)
        rows = h.run(16, 16)
        assert kernel.launches > n
        assert rows.is_cuda and torch.isfinite(rows).all()
        # rows and positions are x-space: the whitened state maps to them
        assert torch.equal(h.positions, pre.to(cuda).to_x(h.state.positions))
        assert torch.equal(rows[:, -1], h.positions)
    # a diagonal metric runs Kernel 7's scaled instance; one whitened
    # twice has no form the kernel runs, and raises
    diag = Preconditioner("diag", scale=torch.linspace(0.5, 2.0, 8))
    n = hmc_separable_step.launches
    n_scaled = hmc_separable_step.scaled_launches
    h = HMC(standard_normal(), torch.zeros((64, 8), device=cuda), 0.1, 4,
            use_pallas="separable", metric=diag).seed(1)
    assert torch.isfinite(h.run(4, 4)).all()
    assert hmc_separable_step.launches == n + 8
    assert hmc_separable_step.scaled_launches == n_scaled + 8
    with pytest.raises(ValueError, match="whitens it once"):
        HMC(h.kernel_target, torch.zeros((64, 8), device=cuda), 0.1, 4,
            use_pallas="separable", metric=diag)


@pytest.mark.cuda
@pytest.mark.parametrize("which,d", [("standard_normal", 10_000),
                                     ("sigma_table", 10_000),
                                     ("sigma_table", 1001),
                                     ("isotropic_gaussian", 37),
                                     ("isotropic_gaussian", 3)])
def test_cuda_scaled_separable_matches_plain(cuda, which, d):
    """Kernel 7's scaled instance against its twin, per chain, on the
    float4 path (D a multiple of 4) and the scalar one (odd D); at D=3
    the functor's std sits past L's triangle in ``cuda_params``."""
    c, n_leapfrog, seed, step = 512, 10, 0x5EED_99, 4
    g = np.random.default_rng(51)
    x = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    if which == "standard_normal":
        t = standard_normal()
    elif which == "isotropic_gaussian":
        t = isotropic_gaussian_target(1.5)
    else:
        t = _sigma_target(torch.logspace(-1, 1, d).to(cuda))
    scale = torch.from_numpy((0.2 + 2.0 * g.random(d)).astype(np.float32))
    pre = Preconditioner("diag", scale=scale.to(cuda))
    w = precondition_target(t, pre)
    assert w.cuda_scaled
    y = pre.to_y(x.to(cuda)).contiguous()
    tables = torch.cat([s.reshape(1, -1).to(cuda)
                        for s in w.sep_forms()[1]])
    eps = torch.tensor([0.15], device=cuda)
    n = hmc_separable.scaled_launches
    got = hmc_separable(w, y, eps, n_leapfrog, seed, step, tables)
    assert hmc_separable.scaled_launches == n + 1
    want = hmc_separable_plain(w, y, eps, n_leapfrog, seed, step, tables)
    ref = hmc_separable_plain(w, y.double(), eps.double(), n_leapfrog, seed,
                              step, tables.double())
    torch.cuda.synchronize()
    assert _share(((got[0] - want[0]).abs() <= ATOL + RTOL * want[0].abs())
                  .all(1)) >= 0.999
    near = (got[0] - ref[0]).abs() <= ATOL + RTOL * ref[0].abs()
    assert _share(near.all(1)) >= 0.999
    for a, b in zip(got[1:4], ref[1:4]):  # the sums, against float64
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    small = hmc_separable(w, y, eps, n_leapfrog, seed, step, tables,
                          threads=64)
    assert torch.equal(small[0], got[0])


@pytest.mark.cuda
def test_cuda_mala_full_blocks_match_plain(cuda):
    """MALA's "full" tier is Kernel 2 at L = 1: a K = 16 block against its
    twin per chain, and the sampler's launches."""
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x = torch.from_numpy(_nuts_state(8192, 71)[0]).to(cuda)
    lp, g = t.batch_logp_and_grad(x)
    eps = torch.full((16,), 0.9, device=cuda)
    hk = torch.empty((16, 8192, 2), device=cuda)
    hp = torch.empty_like(hk)
    k = hmc_multistep(t, x, lp, g, eps, 1, 0x5EED_3, 0, hk)
    p = hmc_multistep_plain(t, x, lp, g, eps, 1, 0x5EED_3, 0, hp)
    torch.cuda.synchronize()
    ok = ((hk - hp).abs() <= ATOL + RTOL * hp.abs()).all(2).all(0)
    ok &= ((k[0] - p[0]).abs() <= ATOL + RTOL * p[0].abs()).all(1)
    assert _share(ok) >= 0.999
    n = hmc_multistep.launches
    m = MALA(t, x, 0.9, use_pallas="full", steps_per_call=16).seed(2)
    rows = m.run(64, 32)
    assert hmc_multistep.launches == n + 6
    assert rows.is_cuda and torch.isfinite(rows).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [False, True, "full", "separable"])
def test_cuda_tuned_leaves_a_finite_step_size(cuda, tier):
    target = (standard_normal() if tier == "separable"
              else diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]))
    x = torch.randn((1024, 2), device=cuda)
    for sampler in (MALA(target, x, 3.0, use_pallas=tier),
                    HMC(target, x, 3.0, 4, use_pallas=tier)):
        tuned = sampler.seed(4).tuned(100)
        assert math.isfinite(tuned.step_size) and tuned.step_size > 0
        assert type(tuned) is type(sampler)
        assert torch.isfinite(tuned.run(8, 8)).all()
    if tier in (False, "full"):
        mh = MetropolisHastings(gaussian2d([0.0, 0.0], [[1.0, 0.0],
                                                        [0.0, 1.0]]),
                                isotropic_gaussian_proposal(25.0), x,
                                use_pallas=tier).seed(4).tuned(100)
        assert 0.0 < mh.scale_factor < 1.0
        assert torch.isfinite(mh.run(8, 8)).all()


def _sep_step_case(which, d, c, cuda, seed):
    """(target, positions, logp, tables) for a fused-step test: the
    standard normal, the isotropic Gaussian, the sigma table
    (logspace(-1, 1, D)) or that table whitened by its own sigma (the
    scaled instance), from positions drawn from the target."""
    g = np.random.default_rng(seed)
    z = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    z = z.to(cuda)
    sigma = torch.logspace(-1, 1, d).to(cuda)
    if which == "standard_normal":
        t, x = standard_normal(), z
    elif which == "isotropic_gaussian":
        t, x = isotropic_gaussian_target(1.5), 1.5 * z
    elif which == "sigma_table":
        t, x = _sigma_target(sigma), z * sigma
    else:
        t = precondition_target(_sigma_target(sigma),
                                Preconditioner("diag", scale=sigma))
        x = z
    tables = (torch.cat([s.reshape(1, -1) for s in t.sep_forms()[1]])
              if t.sep_forms()[1] else torch.empty((0, d), device=cuda))
    return t, x.contiguous(), t.batch_logp(x).float(), tables


def _moved(new, pos):
    return (new != pos.to(new.dtype)).any(dim=1)


def _sep_ref(t, x, lp, eps, n_leapfrog, seed, step, tables, mom=None,
             u=None):
    """The float64 twin's step, the accept uniforms and the ties: the
    chains whose accept_logp lies within the float32 sums' error bound of
    log(u), where either decision is right. A float32 sum of D terms in
    (log2(D) + 8) rounds (the kernel's tree, the twin's pairwise sums)
    errs by at most that many ulps of the terms' magnitude."""
    x64, lp64, t64 = x.double(), lp.double(), tables.double()
    m64 = None if mom is None else mom.double()
    _, lp_prop, ke0, ke1, _ = hmc_separable_plain(
        t, x64, eps.double(), n_leapfrog, seed, step, t64, m64)
    if u is None:
        u = accept_uniforms(x.shape[0], step, seed, x.device)
    gap = ((-lp64 + ke0) - (-lp_prop + ke1)) - torch.log(u.double())
    ulps = (math.log2(x.shape[1]) + 8) * 2.0 ** -24
    tie = gap.abs() <= ulps * (lp64.abs() + lp_prop.abs() + ke0 + ke1)
    ref = hmc_separable_step_plain(t, x64, lp64, eps.double(), n_leapfrog,
                                   seed, step, t64, mom=m64, u=u)
    return ref, tie, u


def _hold_step(got, ref, tie, u, pos):
    """A fused step against the float64 twin per chain: the same accept
    decision on at least 99.9% of the chains that are no tie (at least 90%
    of them), each decision the kernel's own (a chain moved iff its
    alpha_c >= u, up to the rounding of expf and logf); on the chains that
    decide alike, the positions within tolerance, logp within rtol 1e-5
    and alpha_c within 1e-2 on at least 99.9% of them."""
    moved = _moved(got[0], pos)
    same = moved == _moved(ref[0], pos)
    assert _share(~tie) >= 0.9
    assert _share(same[~tie]) >= 0.999
    alpha = got[2]
    assert bool(((alpha >= 0) & (alpha <= 1)).all())
    own = (moved == (alpha >= u)) | ((alpha - u).abs() <= 1e-6)
    assert bool(own.all())
    near = ((got[0] - ref[0]).abs() <= ATOL + RTOL * ref[0].abs()).all(1)
    assert _share(near[same]) >= 0.999
    lp = (got[1].double() - ref[1]).abs() <= 1e-5 * ref[1].abs()
    assert _share(lp[same]) >= 0.999
    # alpha_c = exp(min(accept_logp, 0)), accept_logp a difference of four
    # sums of about D / 2 each: float32 sums over 10,000 coordinates hold
    # it to ~1e-3, so alpha_c to ~1e-3 alpha_c
    close = (alpha.double() - ref[2]).abs() <= 1e-2
    assert _share(close[same]) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("which,d,threads", [
    ("standard_normal", 10_000, 256), ("sigma_table", 10_000, 256),
    ("scaled_sigma_table", 10_000, 256), ("isotropic_gaussian", 1_001, 256),
    ("sigma_table", 4_000, 64), ("standard_normal", 32_768, 256)])
def test_cuda_fused_separable_step_matches_plain(cuda, which, d, threads):
    """Kernel 7's fused step against its twin in float64: the float4 path
    and the scalar one (D not a multiple of 4), clusters of 5, 8 (64
    threads) and 16 tiles (the limit, a non-portable size), every
    functor and the scaled instance; then given the momentum and the
    uniforms (the parity path) against the twin given the same."""
    c = 1024
    t, x, lp, tables = _sep_step_case(which, d, c, cuda, 52)
    assert sep_fused(d, threads) and sep_tiles(d, threads) in (1, 5, 8, 16)
    # a step the narrowest coordinate (sigma 0.1) takes stably and often
    eps = torch.tensor([{"sigma_table": 0.01, "scaled_sigma_table": 0.15}
                        .get(which, 0.1)], device=cuda)
    args = (t, x, lp, eps, 10, 0x5EED_AB, 7, tables)
    n, n2 = hmc_separable_step.launches, hmc_separable.launches
    got = hmc_separable_step(*args, threads=threads)
    assert (hmc_separable_step.launches, hmc_separable.launches) == (n + 1,
                                                                     n2)
    want = hmc_separable_step_plain(*args)
    ref, tie, u = _sep_ref(*args)
    torch.cuda.synchronize()
    _hold_step(got, ref, tie, u, x)
    same = _moved(got[0], x) == _moved(want[0], x)
    assert _share(same[~tie]) >= 0.999  # the float32 twin
    # a rejected chain keeps its position and logp exactly
    kept = ~_moved(got[0], x)
    assert torch.equal(got[1][kept], lp[kept])
    assert 0.05 < _share(~kept) < 1.0
    # the parity path: given momentum and uniforms
    g = np.random.default_rng(53)
    mom = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    u = torch.from_numpy(g.uniform(1e-6, 1.0, c).astype(np.float32))
    mom, u = mom.to(cuda), u.to(cuda)
    got = hmc_separable_step(*args, mom=mom, u=u, threads=threads)
    ref, tie, u = _sep_ref(*args, mom=mom, u=u)
    _hold_step(got, ref, tie, u, x)


@pytest.mark.cuda
def test_cuda_separable_step_past_the_cluster_limit_is_two_pass(cuda):
    """One tile past the 16-tile limit the step launches the
    trajectory-only form and accepts in PyTorch, counted apart, with the
    same draws (momenta and uniform) as the fused form: at D = 8,192 the
    fused step in clusters of 16 (64 threads) and the two-pass form (32
    threads: 32 tiles) agree per chain."""
    assert sep_fused(32_768) and not sep_fused(32_769)
    c = 1024
    t, x, lp, tables = _sep_step_case("sigma_table", 32_769, c, cuda, 54)
    eps = torch.tensor([0.01], device=cuda)
    n, n2 = hmc_separable_step.launches, hmc_separable.launches
    got = hmc_separable_step(t, x, lp, eps, 10, 0x5EED_CD, 2, tables)
    assert (hmc_separable_step.launches, hmc_separable.launches) == (n,
                                                                     n2 + 1)
    ref, tie, u = _sep_ref(t, x, lp, eps, 10, 0x5EED_CD, 2, tables)
    _hold_step(got, ref, tie, u, x)
    # the same step in either form, by layout alone
    t, x, lp, tables = _sep_step_case("standard_normal", 8_192, 1024, cuda,
                                      55)
    eps = torch.tensor([0.1], device=cuda)
    args = (t, x, lp, eps, 10, 0x5EED_EF, 3, tables)
    assert sep_fused(8_192, 64) and not sep_fused(8_192, 32)
    fused = hmc_separable_step(*args, threads=64)
    n2 = hmc_separable.launches
    two = hmc_separable_step(*args, threads=32)
    assert hmc_separable.launches == n2 + 1
    ref, tie, u = _sep_ref(*args)
    assert _share((fused[0] == two[0]).all(1)[~tie]) >= 0.999
    _hold_step(fused, ref, tie, u, x)
    _hold_step(two, ref, tie, u, x)


@pytest.mark.cuda
def test_cuda_separable_step_layouts_and_refusals(cuda):
    """Clusters of 10 (128 threads) give the default clusters of 5's
    result per chain; the wrapper refuses a block size the kernel does not
    take, the C entry a cluster past 16 tiles, and the wrapper raises on
    such codes."""
    t, x, lp, tables = _sep_step_case("sigma_table", 10_000, 1024, cuda,
                                      56)
    eps = torch.tensor([0.01], device=cuda)
    args = (t, x, lp, eps, 10, 0x5EED_12, 9, tables)
    base = hmc_separable_step(*args)
    ten = hmc_separable_step(*args, threads=128)
    assert sep_tiles(10_000, 128) == 10
    tie = _sep_ref(*args)[1]
    assert _share((ten[0] == base[0]).all(1)[~tie]) >= 0.999
    for threads in (48, 512):
        with pytest.raises(ValueError, match="threads"):
            hmc_separable_step(*args, threads=threads)
    from mini_mcmc_torch.ops.kernels import _build
    out = torch.empty_like(x)
    code = _build.lib().mm_hmc_separable_step(
        x.data_ptr(), None, None, lp.data_ptr(), eps.data_ptr(), None,
        tables.data_ptr(), None, None, 1024, 10_000, 10, 2, 0, 32, 1, 0, 1,
        0, 0,
        out.data_ptr(), lp.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert code != 0  # 40 tiles: no cluster of that size
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.check(code)


@pytest.mark.cuda
def test_cuda_separable_step_on_two_streams_at_once(cuda):
    """Two fused launches in flight on two streams give the results of
    one stream, bit for bit (the kernel keeps no state between
    launches)."""
    t, x, lp, tables = _sep_step_case("standard_normal", 10_000, 1024, cuda,
                                      57)
    eps = torch.tensor([0.1], device=cuda)
    halves = [(x[:512].contiguous(), lp[:512].contiguous(), 0),
              (x[512:].contiguous(), lp[512:].contiguous(), 512)]
    want = [hmc_separable_step(t, p, l, eps, 10, 0x5EED_34, 4, tables,
                               chain0=c0) for p, l, c0 in halves]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for (p, l, c0), st in zip(halves, streams):
        with torch.cuda.stream(st):
            got.append(hmc_separable_step(t, p, l, eps, 10, 0x5EED_34, 4,
                                          tables, chain0=c0))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        for p, q in zip(a, b):
            assert torch.equal(p, q)
    # chain0 keys the draws: the halves are the whole launch's rows
    whole = hmc_separable_step(t, x, lp, eps, 10, 0x5EED_34, 4, tables)
    assert torch.equal(torch.cat([got[0][0], got[1][0]]), whole[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4])
def test_cuda_multistep_draws_are_the_stream_words(cuda, d):
    """Kernel 2 draws one word stream per (chain, step): a K = 4 block
    against its twin fed the words of ``rng.stream_words`` by hand (the
    normals in Box-Muller pairs, the accept uniform word 2 ceil(D / 2)),
    per chain."""
    pos, _ = _state(8192, d, seed=60 + d)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos).to(cuda)
    lp, g = t.batch_logp_and_grad(x)
    k, seed, step0 = 4, 0x5EED_56, 11
    eps = torch.full((k,), 0.01, device=cuda)
    accept_word = 2 * ((d + 1) // 2)
    words = [rng.stream_words(8192, accept_word + 1, step0 + i, seed, cuda)
             for i in range(k)]
    assert words[0].shape[1] == (4 if d == 2 else 8)
    mom = torch.stack([rng.pair_normals(w, d) for w in words])
    u = torch.stack([rng.unit_open(w[:, accept_word]) for w in words])
    hk = torch.empty((k, 8192, d), device=cuda)
    hp = torch.empty_like(hk)
    pk = hmc_multistep(t, x, lp, g, eps, 6, seed, step0, hk)
    pp = hmc_multistep_plain(t, x, lp, g, eps, 6, seed, step0, hp, mom=mom,
                             u=u)
    torch.cuda.synchronize()
    moved_k = (hk != torch.cat([x[None], hk[:-1]])).any(2)
    moved_p = (hp != torch.cat([x[None], hp[:-1]])).any(2)
    same = (moved_k == moved_p).all(0)
    near = ((hk - hp).abs() <= ATOL + RTOL * hp.abs()).all(2).all(0)
    near &= ((pk[0] - pp[0]).abs() <= ATOL + RTOL * pp[0].abs()).all(1)
    assert _share(same & near) >= 0.999


def _progress_case(kind, cuda):
    """A fused sampler on the card: Kernel 2 (HMC), 4 (NUTS) or 5 (MH)."""
    g = torch.Generator().manual_seed(71)
    init = torch.randn((2048, 2), generator=g).to(cuda)
    if kind == "hmc":
        return HMC(rosenbrock_nd(), init * 0.3 + 1.0, 0.02, 16,
                   use_pallas="full", jitter=0.3, steps_per_call=4,
                   device=cuda).seed(5), hmc_multistep
    if kind == "nuts":
        return NUTS(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]),
                    init, 0.8, use_pallas="full", device=cuda).seed(5), \
            nuts_step
    return MetropolisHastings(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        isotropic_gaussian_proposal(1.0), init, use_pallas="full",
        steps_per_call=4, device=cuda).seed(5), mh_multistep


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hmc", "nuts", "mh"])
def test_cuda_run_progress_equals_run(cuda, kind):
    """A K-aligned ``run_progress`` gives ``run()``'s cube bit for bit
    from the same seed, through the same kernel launches and no twin."""
    counts = []
    for drive in ("progress", "run"):
        sampler, kernel = _progress_case(kind, cuda)
        before = kernel.launches
        twins = (hmc_multistep_plain.calls, nuts_step_plain.calls,
                 mh_multistep_plain.calls)
        if drive == "progress":
            got, rs = sampler.run_progress(32, 16, stream=io.StringIO(),
                                           time_major=True)
            assert isinstance(rs, RunStats)
        else:
            want = sampler.run(32, 16, time_major=True)
        torch.cuda.synchronize()
        counts.append(kernel.launches - before)
        assert twins == (hmc_multistep_plain.calls, nuts_step_plain.calls,
                         mh_multistep_plain.calls)
    assert got.is_cuda and torch.equal(got, want)
    assert counts[0] == counts[1] > 0


@pytest.mark.cuda
def test_cuda_tracker_update_rows_matches_cpu(cuda):
    """The block fold on the card against the same fold on the CPU."""
    g = np.random.default_rng(17)
    rows = g.standard_normal((16, 4096, 3)).astype(np.float32)
    rows[5] = rows[4]  # a rejected step on every chain
    rows[9, :100] = rows[8, :100]
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = stats.tracker_init(4096, 3, device=dev)
        for lo in (0, 8):
            t = stats.tracker_update_rows(
                t, torch.from_numpy(rows[lo:lo + 8]).to(dev))
        out.append(t)
    got, want = out
    assert got.n == want.n == 16
    for f in ("last_state", "mean", "mean_sq", "p_accept_chains"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(got.p_accept), float(want.p_accept),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_quantile_above_the_cap(cuda):
    """Quantiles and the summary of 2**24 + 1 draws a parameter on the
    card (``torch.quantile`` raises there): the card's quantiles equal the
    CPU's (a sort is exact)."""
    pm = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (2, 2**24 + 1)).astype(np.float32))
    levels = (0.0, 0.05, 0.5, 0.95, 1.0)
    got = _quantile(pm.to(cuda), levels)
    assert torch.equal(got.cpu(), _quantile(pm, levels))
    s = summary(pm.T.reshape(1, -1, 2).to(cuda))
    assert all(bool(torch.isfinite(v).all()) for v in (
        s.rhat, s.ess_bulk, s.ess_tail, s.quantiles, s.mcse_sd))


# the transformed instances of Kernels 1-4 (csrc/targets.cuh:Transformed):
# each (target, D) of MM_DISPATCH under a mixed transform, plain and
# whitened over the transform by a dense metric
TRANSFORMED = [(name, d, kind) for name, d in (("rosenbrock", 2),
                                               ("rosenbrock", 3),
                                               ("rosenbrock", 4),
                                               ("gaussian2d", 2),
                                               ("funnel", 3))
               for kind in (None, "dense")]
TRANSFORMED_IDS = [f"{n}{d}-{k or 'plain'}" for n, d, k in TRANSFORMED]


def _transformed(name, d, kind, c, cuda, seed):
    """A transformed (and whitened) target and its unconstrained (and
    whitened) states: positive() on coordinate 0, interval(-1, 3) on
    coordinate 1 (upper_bounded(4) for the Gaussian), lower_bounded(-2)
    on a third; natural states near the mode."""
    from mini_mcmc_torch.models import (
        CoordinateTransform,
        interval,
        lower_bounded,
        neal_funnel,
        positive,
        upper_bounded,
    )

    table = {0: positive(), 1: interval(-1.0, 3.0)}
    if d > 2:
        table[2] = lower_bounded(-2.0)
    if name == "rosenbrock":
        t, x = rosenbrock_nd(), np.abs(_state(c, d, seed)[0])
    elif name == "gaussian2d":
        t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
        x = np.abs(_nuts_state(c, seed)[0]) * [1.0, -1.0] + [0.0, 1.0]
        table = {0: positive(), 1: upper_bounded(4.0)}
    else:  # the funnel: v > 0 and x_1 in (-1, 3)
        t = neal_funnel(3.0)
        g = np.random.default_rng(seed)
        x = np.abs(g.standard_normal((c, d))) * 0.5 + 0.2
        table = {0: positive(), 1: interval(-1.0, 3.0)}
    tf = CoordinateTransform(table, dim=d)
    w = tf.wrap(t)
    y = tf.to_y(torch.from_numpy(np.asarray(x, np.float32)).to(cuda))
    assert torch.isfinite(y).all() and w.cuda_transform is not None
    if kind is not None:
        pre = _metric(d, kind, seed, 0.5).to(cuda)
        w, y = precondition_target(w, pre), pre.to_y(y)
    return w, y.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name, d, kind", TRANSFORMED, ids=TRANSFORMED_IDS)
def test_cuda_transformed_leapfrog_and_multistep_match_plain(cuda, name, d,
                                                             kind):
    c = 4096
    t, y = _transformed(name, d, kind, c, cuda, seed=90 + d)
    from mini_mcmc_torch.ops.kernels import _build

    assert _build.instance_flags(t) == (3 if kind else 2)
    m = torch.from_numpy(_state(c, d, seed=91 + d)[1]).to(cuda)
    lp, g = t.batch_logp_and_grad(y)
    eps = torch.tensor([0.005], device=cuda)
    n = leapfrog_trajectory.launches
    got = leapfrog_trajectory(t, y, m, g, eps, 8)
    assert leapfrog_trajectory.launches == n + 1
    want = leapfrog_trajectory_plain(t, y, m, g, eps[0], 8)
    for a, b in zip(got, want):  # atol scaled as test_torch_models's
        a, b = a.reshape(c, -1), b.reshape(c, -1)
        scale = b.abs().amax(1, keepdim=True)
        ok = (a - b).abs() <= ATOL + RTOL * (b.abs() + scale)
        assert _share(ok.all(1)) >= 0.999
    ks = torch.full((4,), 0.005, device=cuda)
    hk = torch.empty((4, c, d), device=cuda)
    hp = torch.empty_like(hk)
    pk, lk, gk = hmc_multistep(t, y, lp, g, ks, 6, 1234, 0, hk)
    pp, lpp, gp = hmc_multistep_plain(t, y, lp, g, ks, 6, 1234, 0, hp)
    g_atol = ATOL + RTOL * gp.abs().amax(dim=1, keepdim=True)
    near = (hk - hp).abs() <= ATOL + RTOL * hp.abs()
    agree = near.all(2).all(0) & ((lk - lpp).abs() <= ATOL
                                  + RTOL * lpp.abs())
    agree &= ((gk - gp).abs() <= g_atol + RTOL * gp.abs()).all(1)
    assert _share(agree) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name, d, kind", TRANSFORMED, ids=TRANSFORMED_IDS)
def test_cuda_transformed_nuts_kernels_match_plain(cuda, name, d, kind):
    c, j = 8192, 4
    t, y = _transformed(name, d, kind, c, cuda, seed=100 + d)
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = torch.randn((c, d), generator=gen, device=cuda)
    lp, g = t.batch_logp_and_grad(y)
    eps = torch.full((c,), 0.01 if name == "rosenbrock" else 0.1,
                     device=cuda)
    joint0 = lp - 0.5 * (m * m).sum(1)
    logu = joint0 - torch.empty(c, device=cuda).exponential_(generator=gen)
    v = torch.where(torch.rand(c, generator=gen, device=cuda) < 0.5, -1,
                    1).to(torch.int32)
    active = torch.rand(c, generator=gen, device=cuda) < 0.75
    args = (t, y, m, g, logu, v, j, eps, joint0, active, (12345, -6789), 10)
    got, want = subtree(*args), subtree_plain(*args)
    same = ((got.n == want.n) & (got.s == want.s)
            & (got.n_alpha == want.n_alpha) & (got.diverged == want.diverged))
    for part in (active, ~active):
        assert _share(same[part]) >= 0.999
    s = same & want.s
    for a, b in zip(got[:6], want[:6]):
        a, b = a.reshape(c, -1), b.reshape(c, -1)
        scale = b.abs().amax(1, keepdim=True)
        ok = ((a - b).abs() <= ATOL + RTOL * (b.abs() + scale)).all(1)
        assert _share(ok | ~s) >= 0.999
    n = nuts_step.launches
    got = nuts_step(t, y, eps, 10, 0xC0FFEE, 17, 10)
    assert nuts_step.launches == n + 1
    want = nuts_step_plain(t, y, eps, 10, 0xC0FFEE, 17, 10)
    same_pos = (got[0] - want[0]).abs().le(ATOL + RTOL * want[0].abs())
    assert _share(same_pos.all(1)) >= 0.999
    for a, b in zip(got[1:4], want[1:4]):
        assert _share((a - b).abs() <= ATOL + RTOL * b.abs()) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 4])
def test_cuda_neal_funnel_kernels_match_plain(cuda, d):
    """The NealFunnel functor through Kernels 1-4 against the twins on the
    funnel's batch forms, from states in its body (v near 0)."""
    from mini_mcmc_torch.models import neal_funnel

    c = 8192
    t = neal_funnel(3.0)
    g = np.random.default_rng(110 + d)
    x = torch.from_numpy((0.5 * g.standard_normal((c, d))).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    m = m.to(cuda)
    lp, gr = t.batch_logp_and_grad(x)
    eps1 = torch.tensor([0.05], device=cuda)
    for a, b in zip(leapfrog_trajectory(t, x, m, gr, eps1, 8),
                    leapfrog_trajectory_plain(t, x, m, gr, eps1[0], 8)):
        ok = (a - b).abs() <= ATOL + RTOL * b.abs()
        assert _share(ok.reshape(c, -1).all(1)) >= 0.999
    ks = eps1.repeat(4)
    pk, lk, _ = hmc_multistep(t, x, lp, gr, ks, 6, 77, 0)
    pp, lpp, _ = hmc_multistep_plain(t, x, lp, gr, ks, 6, 77, 0)
    ok = ((pk - pp).abs() <= ATOL + RTOL * pp.abs()).all(1)
    assert _share(ok & ((lk - lpp).abs() <= ATOL + RTOL * lpp.abs())) >= 0.999
    eps = torch.full((c,), 0.2, device=cuda)
    got = nuts_step(t, x, eps, 10, 0xF00D, 3, 10)
    want = nuts_step_plain(t, x, eps, 10, 0xF00D, 3, 10)
    assert _share((got[0] - want[0]).abs().le(
        ATOL + RTOL * want[0].abs()).all(1)) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999
    joint0 = lp - 0.5 * (m * m).sum(1)
    logu = joint0 - 1.0
    v = torch.ones(c, dtype=torch.int32, device=cuda)
    active = torch.ones(c, dtype=torch.bool, device=cuda)
    for j in range(4):
        args = (t, x, m, gr, logu, v, j, eps, joint0, active, (5, 6), 10)
        sg, sp = subtree(*args), subtree_plain(*args)
        assert _share((sg.n == sp.n) & (sg.s == sp.s)) >= 0.999


def _sep_transformed(which, d, c, cuda, seed, scaled=False):
    """(transformed target, unconstrained states, logp, tables) on the
    separable tier: ``positive()`` on every coordinate of a standard
    normal (the [sep_constrained] stage's), or a mixed table of five
    blocks (identity, positive, lower_bounded(-1), upper_bounded(2),
    interval(0, 1)) over the standard normal, the sigma table or the
    isotropic Gaussian; ``scaled``: whitened by a diagonal metric."""
    from mini_mcmc_torch.models import (
        CoordinateTransform,
        identity,
        interval,
        lower_bounded,
        positive,
        upper_bounded,
    )

    g = np.random.default_rng(seed)
    z = torch.from_numpy(g.standard_normal((c, d)).astype(np.float32))
    z = z.to(cuda)
    if which == "positive":
        tf = CoordinateTransform({i: positive() for i in range(d)}, dim=d)
        t, x = standard_normal(), z.abs()
    else:
        kinds = [identity(), positive(), lower_bounded(-1.0),
                 upper_bounded(2.0), interval(0.0, 1.0)]
        block = torch.arange(d, device=cuda) * 5 // d
        tf = CoordinateTransform({i: kinds[i * 5 // d] for i in range(d)},
                                 dim=d)
        sigma = {"mixed": torch.ones(d, device=cuda),
                 "mixed_sigma": torch.logspace(-1, 1, d).to(cuda),
                 "mixed_iso": torch.full((d,), 1.5, device=cuda)}[which]
        t = {"mixed": standard_normal(),
             "mixed_sigma": _sigma_target(sigma),
             "mixed_iso": isotropic_gaussian_target(1.5)}[which]
        # natural states from the target folded into each block's range
        x = sigma * z
        x = torch.where(block == 1, x.abs(), x)
        x = torch.where(block == 2, -1.0 + (x + 1.0).abs(), x)
        x = torch.where(block == 3, 2.0 - (2.0 - x).abs(), x)
        x = torch.where(block == 4, x.abs().clamp(0.01, 0.99), x)
    w = tf.wrap(t)
    y = tf.to_y(x)
    assert torch.isfinite(y).all()
    if scaled:
        pre = Preconditioner("diag", scale=torch.from_numpy(
            (0.5 + g.random(d)).astype(np.float32)).to(cuda))
        w = precondition_target(w, pre)
        y = pre.to_y(y)
    y = y.contiguous()
    tables = torch.cat([s.reshape(1, -1).to(cuda).float()
                        for s in w.sep_forms()[1]])
    return w, y, w.batch_logp(y).float(), tables


SEP_TRANSFORMED = [("positive", 10_000, False), ("mixed", 10_000, False),
                   ("mixed", 10_000, True), ("mixed_sigma", 4_000, False),
                   ("mixed_sigma", 4_000, True), ("mixed_iso", 1_001, False),
                   ("mixed_iso", 37, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("which,d,scaled", SEP_TRANSFORMED)
def test_cuda_transformed_separable_matches_plain(cuda, which, d, scaled):
    """Kernel 7's transformed instances (csrc/coord_targets.cuh:
    TransformedCoord, the scale multiplying y = s z ahead of the bijectors
    under a metric) against the twins on the transformed sep_form: the
    trajectory per chain against float64, its sums at rtol 1e-5, the draws
    under another grid; the fused step's decisions against float64, as
    the plain instances are held (float4 and scalar paths)."""
    from mini_mcmc_torch.ops.kernels.hmc_sep import sep_instance

    c, n_leapfrog, seed, step = 512, 10, 0x5EED_7A, 5
    t, y, lp, tables = _sep_transformed(which, d, c, cuda, 120 + d, scaled)
    assert sep_instance(t)[2] == 2 | scaled
    eps = torch.tensor([0.05], device=cuda)
    n = hmc_separable.transformed_launches
    got = hmc_separable(t, y, eps, n_leapfrog, seed, step, tables)
    assert hmc_separable.transformed_launches == n + 1
    ref = hmc_separable_plain(t, y.double(), eps.double(), n_leapfrog, seed,
                              step, tables.double())
    torch.cuda.synchronize()
    near = (got[0] - ref[0]).abs() <= ATOL + RTOL * ref[0].abs()
    assert _share(near.all(1)) >= 0.999
    for a, b in zip(got[1:4], ref[1:4]):  # the sums, against float64
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    small = hmc_separable(t, y, eps, n_leapfrog, seed, step, tables,
                          threads=64)
    assert torch.equal(small[0], got[0])
    # the fused step
    args = (t, y, lp, eps, n_leapfrog, seed, step, tables)
    n = hmc_separable_step.transformed_launches
    step_got = hmc_separable_step(*args)
    assert hmc_separable_step.transformed_launches == n + 1
    step_ref, tie, u = _sep_ref(*args)
    _hold_step(step_got, step_ref, tie, u, y)


@pytest.mark.cuda
def test_cuda_transformed_samplers_and_refusals(cuda):
    """transform= on the fused tiers launches the transformed instances;
    the targets the kernels cannot run raise by name at construction."""
    from mini_mcmc_torch.models import (
        Bijector,
        CoordinateTransform,
        positive,
    )

    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = tf.to_x(torch.randn((1024, 2), device=cuda))
    n = nuts_step.launches
    nuts = NUTS(t, x0, 0.8, use_pallas="full", transform=tf).seed(3)
    s = nuts.run(64, 64)
    assert nuts_step.launches == n + 127 and (s[..., 0] > 0).all()
    n = hmc_multistep.launches
    h = HMC(t, x0, 0.3, 8, use_pallas="full", steps_per_call=8,
            transform=tf).seed(3)
    assert (h.run(64, 64)[..., 0] > 0).all()
    assert hmc_multistep.launches == n + 16
    custom = CoordinateTransform({0: Bijector(torch.exp, torch.log,
                                              lambda y: y)}, dim=2)
    for tier in (True, "full"):
        with pytest.raises(ValueError, match="custom Bijector"):
            HMC(t, x0, 0.3, 8, use_pallas=tier, transform=custom)
        with pytest.raises(ValueError, match="custom Bijector"):
            NUTS(t, x0, 0.8, use_pallas=tier, transform=custom)
    HMC(t, x0, 0.3, 8, transform=custom).run(4)  # the plain tier runs it
    with pytest.raises(ValueError, match="whitened"):
        over = tf.wrap(precondition_target(t, _metric(2, "diag", 1)))
        HMC(over, torch.randn((64, 2), device=cuda), 0.3, 8,
            use_pallas="full")
    # MH under a transform runs Kernel 5's transformed instance
    n = mh_multistep.transformed_launches
    mh = MetropolisHastings(t, isotropic_gaussian_proposal(0.5), x0,
                            use_pallas="full", steps_per_call=8,
                            transform=tf).seed(3)
    assert (mh.run(32, 32)[..., 0] > 0).all()
    assert mh_multistep.transformed_launches == n + 8
    sep = CoordinateTransform({i: positive() for i in range(64)}, dim=64)
    xs = sep.to_x(torch.randn((256, 64), device=cuda))
    n = hmc_separable_step.transformed_launches
    hs = HMC(standard_normal(), xs, 0.2, 8, use_pallas="separable",
             transform=sep).seed(1)
    assert (hs.run(16, 16) > 0).all()
    assert hmc_separable_step.transformed_launches == n + 32


# the transformed instances of Kernels 5 and 8 (targets.cuh:Transformed)
MH_TRANSFORMED = [("gaussian2d", 2, 0.6), ("rosenbrock", 2, 0.1),
                  ("rosenbrock", 3, 0.1)]


def _logp_near(got, want, rounding):
    """Within MH's rtol/atol and twice the transformed density's float32
    rounding (``CoordinateTransform.density_rounding``): the kernel and
    its twin each miss the float64 density by up to that."""
    return ((got - want).double().abs()
            <= 1e-6 + 1e-5 * want.double().abs() + 2 * rounding)


def _mh_transformed(name, d, c, cuda, seed):
    """_transformed's tables and states, with the inner target and the
    transform."""
    from mini_mcmc_torch.models import (
        CoordinateTransform,
        interval,
        lower_bounded,
        positive,
        upper_bounded,
    )

    if name == "gaussian2d":
        t = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
        x = np.abs(_nuts_state(c, seed)[0]) * [1.0, -1.0] + [0.0, 1.0]
        table = {0: positive(), 1: upper_bounded(4.0)}
    else:
        t, x = rosenbrock_nd(), np.abs(_state(c, d, seed)[0])
        table = {0: positive(), 1: interval(-1.0, 3.0)}
        if d > 2:
            table[2] = lower_bounded(-2.0)
    tf = CoordinateTransform(table, dim=d)
    y = tf.to_y(torch.from_numpy(np.asarray(x, np.float32)).to(cuda))
    return t, tf, tf.wrap(t), y.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name, d, std", MH_TRANSFORMED)
def test_cuda_transformed_mh_multistep_matches_plain(cuda, name, d, std):
    c, k = 8192, 16
    t, tf, w, y = _mh_transformed(name, d, c, cuda, seed=120 + d)
    p = isotropic_gaussian_proposal(std)
    lp = w.batch_logp(y)
    hk = torch.empty((k, c, d), device=cuda)
    hp = torch.empty_like(hk)
    n, nt = mh_multistep.launches, mh_multistep.transformed_launches
    pk, lk = mh_multistep(w, p, y, lp, 0xFACE, 3, k, hk)
    assert mh_multistep.launches == n + 1
    assert mh_multistep.transformed_launches == nt + 1
    pp, lpp = mh_multistep_plain(w, p, y, lp, 0xFACE, 3, k, hp)
    torch.cuda.synchronize()
    agree = _near(hk, hp).all(2).all(0) & _near(pk, pp).all(1)
    agree &= _logp_near(lk, lpp, tf.density_rounding(t, pp))
    assert _share(agree) >= 0.999
    moved = (hk[1:] != hk[:-1]).any(2)
    assert 0.1 < _share(moved) < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mixture", "gaussian2d"])
def test_cuda_transformed_pt_multistep_matches_plain(cuda, which):
    from mini_mcmc_torch.models import CoordinateTransform, interval

    c, k, n_temps = 8192, 16, 8
    if which == "mixture":
        g = np.random.default_rng(61)
        x = g.choice([-8.0, 8.0], (c, 1)) + 0.5 * g.standard_normal((c, 1))
        t = _mixture()
        tf = CoordinateTransform({0: interval(-24.0, 24.0)}, dim=1)
        w = tf.wrap(t)
        y = tf.to_y(torch.from_numpy(x.astype(np.float32)).to(cuda))
        d, std = 1, 0.1
    else:
        t, tf, w, y = _mh_transformed("gaussian2d", 2, c, cuda, seed=62)
        d, std = 2, [0.5, 0.3]
    betas = geometric_betas(n_temps, 0.01)
    pt = ParallelTempering(w, y, betas=betas, proposal_std=std, device=cuda)
    s = pt.state
    lad = make_ladder(betas, std, d, cuda)
    hk = torch.empty((k, c, d), device=cuda)
    hp = torch.empty_like(hk)
    args = (w, s.positions, s.raw_logp, s.swap_accept, 1, lad, 0xBEEF, 7,
            k, 1)
    n, nt = pt_multistep.launches, pt_multistep.transformed_launches
    got = pt_multistep(*args, hk)
    assert pt_multistep.launches == n + 1
    assert pt_multistep.transformed_launches == nt + 1
    want = pt_multistep_plain(*args, hp)
    torch.cuda.synchronize()
    # the proposals round alike; the transformed density differs from the
    # twin's within its float32 rounding (density_rounding), so an accept on
    # such a tie may flip
    same = _near(got[0], want[0]).all(1).all(0)
    same &= (got[2] == want[2]).all(0) & _near(hk, hp).all(2).all(0)
    tol = tf.density_rounding(t, want[0].permute(0, 2, 1).reshape(-1, d))
    lp_ok = _logp_near(got[1], want[1], tol.reshape(n_temps, c)).all(0)
    assert _share(same & lp_ok) >= 0.999
    assert 0.05 < _share((hk[1:] != hk[:-1]).any(2)) < 0.95


@pytest.mark.cuda
def test_cuda_transformed_mh_and_pt_samplers_and_refusals(cuda):
    from mini_mcmc_torch.models import (
        CoordinateTransform,
        interval,
        positive,
    )

    tf = CoordinateTransform({0: positive()}, dim=2)
    g2 = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    x0 = tf.to_x(torch.randn((8192, 2), device=cuda))
    n = mh_multistep.transformed_launches
    mh = MetropolisHastings(g2, isotropic_gaussian_proposal(1.0), x0,
                            use_pallas="full", steps_per_call=16,
                            transform=tf).seed(8)
    s = mh.run(512, 512, time_major=True)
    assert mh_multistep.transformed_launches == n + 64
    assert (s[..., 0] > 0).all() and torch.isfinite(s).all()
    assert abs(float(s[..., 0].mean()) - math.sqrt(2 / math.pi)) < 0.05
    itf = CoordinateTransform({0: interval(-24.0, 24.0)}, dim=1)
    n = pt_multistep.transformed_launches
    pt = ParallelTempering(_mixture(), torch.full((1024, 1), -8.0,
                                                  device=cuda),
                           betas=geometric_betas(8, 0.01), proposal_std=0.1,
                           steps_per_call=16, use_pallas="full",
                           transform=itf).seed(5)
    s = pt.run(256, 256)
    assert pt_multistep.transformed_launches == n + 32
    assert ((s > -24.0) & (s < 24.0)).all()
    assert 0.5 < float((s > 0).float().mean()) < 0.9
    # a whitened target has no instance in either kernel
    pre = _metric(2, "diag", 1).to(cuda)
    with pytest.raises(ValueError, match="whitened"):
        MetropolisHastings(precondition_target(g2, pre),
                           isotropic_gaussian_proposal(1.0), x0,
                           use_pallas="full")
    with pytest.raises(ValueError, match="whitened"):
        ParallelTempering(precondition_target(g2, pre), x0,
                          use_pallas="full")


@pytest.mark.cuda
def test_cuda_new_samplers_default_to_the_card(cuda):
    # no device argument: the state, the cube and the cached densities on
    # the card, and each sampler's moments right at a small size
    g = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x = torch.randn((4096, 2))
    ch = ChEESHMC(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]),
                  x, step_size=0.5, seed=1).warmed_up(100)
    es = EnsembleSampler(g, x, walkers_per_ensemble=64,
                         steps_per_call=16).seed(2)
    sl = SliceSampler(g, x, steps_per_call=16).seed(3)
    lik = Target(logp=lambda f: -0.5 * torch.sum((f - 1.0) ** 2, dim=-1))
    el = EllipticalSliceSampler(lik, x, prior_scale=[1.0, 2.0],
                                steps_per_call=16).seed(4)
    for s, mean, var in ((ch, [0.0, 1.0], [4.0, 3.0]),
                         (es, [0.0, 1.0], [4.0, 3.0]),
                         (sl, [0.0, 1.0], [4.0, 3.0]),
                         (el, [0.5, 0.8], [0.5, 0.8])):
        assert s.state.positions.is_cuda
        cube = s.run(128, 64)
        assert cube.is_cuda and cube.shape == (4096, 128, 2)
        flat = cube.reshape(-1, 2).double()
        assert (flat.mean(0).cpu() - torch.tensor(mean)).abs().max() < 0.1
        assert ((flat.var(0).cpu() / torch.tensor(var)) - 1).abs().max() < 0.1


@pytest.mark.cuda
def test_cuda_chees_run_reads_nothing_from_the_device(cuda):
    # the production kernel's leapfrog count is a host integer (its jitter
    # drawn by place on the host): run() makes no device-to-host read
    ch = ChEESHMC(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]),
                  torch.randn((65536, 2)), step_size=0.5,
                  seed=17).warmed_up(64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cube = ch.run(256, 0, time_major=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(cube).all()


def _evidence_target(device):
    """bench.py:1008-1019's unnormalized correlated Gaussian2D on
    ``device`` and its analytic log Z."""
    cov = torch.tensor([[4.0, 2.0], [2.0, 3.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov).float().to(device)
    true = 0.5 * (2 * math.log(2 * math.pi)
                  + math.log(float(torch.linalg.det(cov))))
    return Target(logp=lambda xs: -0.5 * torch.einsum(
        "ni,ij,nj->n", xs, prec, xs)), true


@pytest.mark.cuda
def test_cuda_evidence_estimators_on_the_card(cuda):
    # bench.py:1003-1076's settings at 8,192 particles, no device argument
    t, true = _evidence_target(cuda)
    kw = dict(proposal_std=1.0, prior_std=2.5)
    r = ais_log_z(t, 8192, 2, betas=64, n_mh_steps=2, seed=0, **kw)
    assert r.positions.is_cuda and r.log_weights.is_cuda
    assert abs(float(r.log_z) - true) < 0.05 and float(r.weight_ess) > 0.3
    s = smc_log_z(t, 8192, 2, seed=1, **kw)
    assert s.positions.is_cuda and float(s.betas[-1]) == 1.0
    assert abs(float(s.log_z) - true) < 0.05
    # an anneal reads nothing from the device
    anneal = make_anneal(t, (0.25, 0.5, 1.0), n_mh_steps=2, **kw)
    x0 = 2.5 * torch.randn((8192, 2), device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, log_w = anneal(x0, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(log_w).all() and x.is_cuda
    # device="cpu" is honoured
    tc, _ = _evidence_target("cpu")
    assert ais_log_z(tc, 512, 2, betas=8, device="cpu",
                     **kw).positions.device.type == "cpu"
    assert smc_log_z(tc, 512, 2, device="cpu",
                     **kw).positions.device.type == "cpu"


def _regression(device, n=65536, d=8):
    """bench.py:1085-1110's conjugate regression: the minibatch estimator
    on ``device`` and the analytic posterior mean and variances."""
    g = np.random.default_rng(0)
    x = g.standard_normal((n, d)).astype(np.float32)
    x /= np.sqrt(d)
    y = (x @ np.linspace(-1.0, 1.0, d).astype(np.float32)
         + 0.5 * g.standard_normal(n)).astype(np.float32)
    x64 = x.astype(np.float64)
    cov = np.linalg.inv(x64.T @ x64 / 0.25 + np.eye(d) / 4.0)
    mean = cov @ (x64.T @ y.astype(np.float64)) / 0.25
    grad_fn = minibatch_grad(
        lambda w: -0.5 * torch.sum(w * w) / 4.0,
        lambda w, b: -0.5 * torch.sum((b[1] - b[0] @ w) ** 2) / 0.25,
        (x, y), batch_size=1024, device=device)
    return grad_fn, mean, np.diag(cov)


def _moments(cube):
    flat = cube.reshape(-1, cube.shape[-1]).double()
    return (flat.mean(0).cpu().numpy(),
            flat.var(0, unbiased=False).cpu().numpy())


@pytest.mark.cuda
def test_cuda_sgmcmc_on_the_card(cuda):
    # bench.py:1078-1257's three stages at 1,024 chains, no device argument
    grad_fn, post_mean, post_var = _regression(cuda)
    for cls, kw, var_tol in (
            (SGLD, dict(step_size=polynomial_decay(2e-6, 50.0, 0.33)), 0.3),
            (SGHMC, dict(step_size=polynomial_decay(1e-6, 50.0, 0.33),
                         friction=0.5), 0.4)):
        s = cls(grad_fn, torch.randn((1024, 8)), seed=21, steps_per_call=16,
                **kw)
        assert s.state.positions.is_cuda
        s.run(2048, 2048, time_major=True)
        mean, var = _moments(s.run(2048, time_major=True))
        assert np.max(np.abs(mean - post_mean) / np.sqrt(post_var)) <= 1.0
        assert np.max(np.abs(var / post_var - 1.0)) <= var_tol
        # a run reads nothing from the device
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cube = s.run(32, time_major=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert cube.is_cuda and s.state.step == 6176
    sigma2 = torch.logspace(0.0, 2.0, 8, device=cuda)
    ps = SGLD(lambda x, key: -x / sigma2, torch.randn((1024, 8)),
              step_size=0.02, seed=27, preconditioner="rmsprop",
              rms_decay=0.9999, steps_per_call=16)
    ps.run(2048, 4096, time_major=True)
    _, var = _moments(ps.run(2048, time_major=True))
    assert np.max(np.abs(var / sigma2.cpu().numpy() - 1.0)) <= 0.3
    assert 80.0 < var[-1] / var[0] < 140.0
    # device="cpu" is honoured
    c = SGLD(target_grad(standard_normal()), torch.zeros((4, 2)),
             step_size=0.05, device="cpu")
    assert c.run(8).device.type == "cpu"
    assert _regression("cpu", n=2048, d=2)[0](
        torch.zeros((4, 2)), torch.Generator().manual_seed(0)
    ).device.type == "cpu"


# -- the run tooling: checkpoint resume, export and load on the card ---------


def _resume_samplers(dev):
    """A small sampler of each fused kernel's path on ``dev``, by seed,
    with the kernel wrapper that its runs launch."""
    g = torch.Generator().manual_seed(31)
    x2 = torch.randn((256, 2), generator=g)
    x3 = torch.randn((256, 3), generator=g) * 0.3 + 1.0
    kw = dict(device=dev)
    return {
        "k2_hmc": (hmc_multistep, lambda s: HMC(
            rosenbrock_nd(), x3, 0.02, 8, use_pallas="full", jitter=0.3,
            steps_per_call=4, **kw).seed(s)),
        "k4_nuts": (nuts_step, lambda s: NUTS(
            diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]), x2,
            0.8, use_pallas="full", **kw).seed(s)),
        "k5_mh": (mh_multistep, lambda s: MetropolisHastings(
            gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
            isotropic_gaussian_proposal(1.0), x2, use_pallas="full",
            steps_per_call=4, **kw).seed(s)),
        "k6_gibbs": (gibbs_multistep, lambda s: GibbsSampler(
            gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
            torch.zeros((256, 2)), use_pallas="full", steps_per_call=4,
            **kw).seed(s)),
        "k7_separable": (hmc_separable_step, lambda s: HMC(
            standard_normal(), torch.randn((64, 512), generator=g), 0.1, 5,
            use_pallas="separable", **kw).seed(s)),
        "k8_tempering": (pt_multistep, lambda s: ParallelTempering(
            _mixture(), torch.full((256, 1), -8.0), betas=(1.0, 0.3, 0.1),
            steps_per_call=4, use_pallas="full", **kw).seed(s)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k2_hmc", "k4_nuts", "k5_mh", "k6_gibbs",
                                  "k7_separable", "k8_tempering"])
def test_cuda_checkpoint_resumes_through_the_kernel(cuda, tmp_path, name):
    from mini_mcmc_torch.checkpoint import restore_sampler, save_sampler

    kernel, make = _resume_samplers(cuda)[name]
    a = make(9)
    a.run(8, 8 if name == "k4_nuts" else 0)
    path = str(tmp_path / "ckpt")
    save_sampler(path, a)
    n = kernel.launches
    cont_a = a.run(8)
    launched = kernel.launches - n
    b = make(4321)
    restore_sampler(path, b)
    assert b.state.positions.is_cuda
    n = kernel.launches
    cont_b = b.run(8)
    assert kernel.launches - n == launched > 0
    assert cont_a.is_cuda and torch.equal(cont_a, cont_b)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


@pytest.mark.cuda
def test_cuda_checkpoint_restores_into_a_cpu_sampler(cuda, tmp_path):
    from mini_mcmc_torch.checkpoint import (
        load_checkpoint,
        restore_sampler,
        save_sampler,
    )

    _, make = _resume_samplers(cuda)["k2_hmc"]
    a = make(3)
    a.run(8)
    path = str(tmp_path / "ckpt")
    save_sampler(path, a)
    # load_checkpoint's default device is the card
    state, gen = load_checkpoint(path)
    assert all(x.is_cuda for x in state)
    assert torch.equal(gen.get_state(), a._gen.get_state())
    # the card's checkpoint restores into the CPU twin, state bit for bit
    cpu = HMC(rosenbrock_nd(), torch.zeros((256, 3)), 0.02, 8,
              use_pallas="full", jitter=0.3, steps_per_call=4,
              device="cpu")
    restore_sampler(path, cpu)
    for x, y in zip(cpu.state, a.state):
        assert x.device.type == "cpu" and torch.equal(x, y.cpu())
    cube = cpu.run(8)
    assert cube.device.type == "cpu" and bool(torch.isfinite(cube).all())


@pytest.mark.cuda
def test_cuda_save_csv_tensor_native(cuda, tmp_path):
    from mini_mcmc_torch.io import save_csv_tensor

    cube = torch.randn((16, 64, 3), device=cuda)
    path = str(tmp_path / "cube.csv")
    save_csv_tensor(cube, path, native=True)
    with open(path) as f:
        assert f.readline() == "chain,observation,dim_0,dim_1,dim_2\n"
    vals = np.loadtxt(path, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(
        vals[:, 2:], cube.cpu().double().numpy().reshape(-1, 3))
    np.testing.assert_array_equal(vals[:, 0], np.repeat(np.arange(16), 64))


# -- user densities in Kernels 1-4 (ops/kernels/user_density.py) ------------


def _es8_start(form, kind, cuda, c=2048, seed=3):
    """The eight-schools target in ``form`` at D = 10 and a start: plain
    in x, or whitened by a diagonal metric in y."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    t = make_noncentered_target(form)
    g = np.random.default_rng(seed)
    pos = torch.from_numpy((0.5 * g.standard_normal((c, 10))).astype(
        np.float32)).to(cuda)
    eps = 0.05
    if kind == "whitened":
        scale = torch.linspace(0.5, 3.0, 10, device=cuda)
        t = precondition_target(t, Preconditioner("diag", scale=scale))
        pos, eps = pos / scale, 0.05 / 3.0
    return t, pos.contiguous(), eps


def _share(ok):
    return float(ok.double().mean())


def _rows_close(a, b):
    ok = (a - b).abs() <= ATOL + RTOL * (b.abs() + b.abs().amax(
        dim=-1, keepdim=True))
    return ok.reshape(ok.shape[0], -1).all(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["hand", "derived", "traced"])
@pytest.mark.parametrize("kind", ["plain", "whitened"])
def test_cuda_user_instances_match_their_twins(form, kind, cuda):
    """Each user instance of Kernels 1-4 at D = 10 (eight schools, plain
    and whitened diag: mm::WhitenedDiag) against its twin as the built-in
    instances are held: positions, gradients and counts per chain on at
    least 99.9% of the chains."""
    t, pos, eps = _es8_start(form, kind, cuda)
    c = pos.shape[0]
    flags = 5 if kind == "whitened" else 0
    assert _build.instance_flags(t) == flags
    gen = torch.Generator(device=cuda).manual_seed(7)
    mom = torch.randn(pos.shape, generator=gen, device=cuda)
    logp, grad = t.batch_logp_and_grad(pos)
    e = torch.tensor(eps, device=cuda)
    before = leapfrog_trajectory.user_launches
    got = leapfrog_trajectory(t, pos, mom, grad, e, 8)
    want = leapfrog_trajectory_plain(t, pos, mom, grad, e, 8)
    assert leapfrog_trajectory.user_launches == before + 1
    ok = _rows_close(got[0], want[0]) & _rows_close(got[3], want[3])
    assert _share(ok) >= 0.999
    got = hmc_multistep(t, pos, logp, grad, e.expand(4).contiguous(), 8,
                        99, 3)
    want = hmc_multistep_plain(t, pos, logp, grad, e.expand(4).contiguous(),
                               8, 99, 3)
    assert _share(_rows_close(got[0], want[0])) >= 0.999
    joint0 = logp - 0.5 * (mom * mom).sum(1)
    logu = joint0 - torch.empty_like(joint0).exponential_(generator=gen)
    v = torch.where(torch.rand(c, generator=gen, device=cuda) < 0.5, -1,
                    1).to(torch.int32)
    active = torch.ones(c, dtype=torch.bool, device=cuda)
    eps_c = torch.full((c,), eps, device=cuda)
    args = (t, pos, mom, grad, logu, v, 3, eps_c, joint0, active, (5, 6), 10)
    got, want = subtree(*args), subtree_plain(*args)
    same = (got.n == want.n) & (got.s == want.s) & (
        got.n_alpha == want.n_alpha)
    assert _share(same) >= 0.999
    assert _share(_rows_close(got.end_pos, want.end_pos) | ~want.s) >= 0.999
    got = nuts_step(t, pos, eps_c * 4, 10, 0x5EED, 2, 10)
    want = nuts_step_plain(t, pos, eps_c * 4, 10, 0x5EED, 2, 10)
    assert _share(_rows_close(got[0], want[0])) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999


#: Kernel 4's threads a block by D (csrc/nuts_full.cuh:step_threads): 128
#: while a lane's depth-10 stack, 3 D + 1 floats a row, fits 128 lanes in
#: a block's 232,448 B (D <= 14), else 64
K4_THREADS = {**dict.fromkeys(range(1, 15), 128), 15: 64, 16: 64}


def _banded_gaussian(d):
    """A Gaussian at D = ``d`` with neighbours coupled, traced: ``z = x /
    s``, ``logp = -z.z / 2 - sum(z_i z_(i+1)) / 4`` (its precision
    ``I + (shift + shift^T) / 4`` is positive definite), ``s`` 0.5..2.0,
    so that each coordinate's gradient reads its neighbours."""
    s = torch.linspace(0.5, 2.0, d)

    def logp(x):
        z = x / s.to(x.device)
        return (-0.5 * torch.sum(z * z, dim=-1)
                - 0.25 * torch.sum(z[..., :-1] * z[..., 1:], dim=-1))
    return Target(logp=logp)


def _example_k4_target(case):
    """The user libraries the port's NUTS examples run in Kernel 4 on the
    card, with their D and a range of step sizes: minimal_nuts' 2D
    Rosenbrock, eight schools' centered form and constrained_transforms'
    natural target inside its transform's bijectors, each traced from its
    batch form."""
    from mini_mcmc_torch.examples import constrained_transforms as ct
    from mini_mcmc_torch.examples.eight_schools import make_centered_target

    if case == "rosenbrock2":
        return rosenbrock2d(1.0, 100.0), 2, 0.01, 0.05
    if case == "centered":
        return make_centered_target(), 10, 0.05, 0.2
    return ct.make_transform().wrap(ct.make_natural_target()), 2, 0.05, 0.2


def _k4_user_case(case, kind, cuda, c=4096, seed=41):
    """Kernel 4's user instance and a start: ``"gauss<D>"`` the
    traced banded Gaussian, an example's target
    (:func:`_example_k4_target`), else eight schools' form ``case`` at
    D = 10; plain in x, or whitened by a diagonal metric in y."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    if case.startswith("gauss"):
        d = int(case[5:])
        t, lo, hi = _banded_gaussian(d), 0.15, 0.45
    elif case in ("rosenbrock2", "centered", "constrained"):
        t, d, lo, hi = _example_k4_target(case)
    else:
        d = 10
        t, lo, hi = make_noncentered_target(case), 0.05, 0.2
    g = np.random.default_rng(seed + d)
    pos = torch.from_numpy((0.8 * g.standard_normal((c, d))).astype(
        np.float32)).to(cuda)
    eps = torch.from_numpy(g.uniform(lo, hi, c).astype(np.float32)).to(cuda)
    if kind == "whitened":
        scale = torch.linspace(0.5, 2.0, d, device=cuda)
        t = precondition_target(t, Preconditioner("diag", scale=scale))
        pos = pos / scale
    return t, pos.contiguous(), eps


def _k4_against_twin(t, pos, eps, key=0xC0FFEE, step=17):
    """Kernel 4 and its twin for one step: the kernel's outputs, its grid
    and stats, the twin's outputs and details."""
    stats = torch.zeros(2, dtype=torch.int64, device=pos.device)
    grid, details = {}, {}
    got = nuts_step(t, pos, eps, 10, key, step, 10, stats=stats, grid=grid)
    want = nuts_step_plain(t, pos, eps, 10, key, step, 10, details=details)
    torch.cuda.synchronize()
    return got, grid, stats.cpu(), want, details


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "whitened"])
@pytest.mark.parametrize("case", ["gauss5", "gauss6", "gauss8", "gauss10",
                                  "gauss12", "gauss15", "gauss16", "hand",
                                  "derived", "traced", "rosenbrock2",
                                  "centered", "constrained"])
def test_cuda_nuts_step_user_dims_match_their_twin(case, kind, cuda):
    """Kernel 4's user instances at D = 2-16 (the last quad of momenta
    partly filled at D = 2, 5, 6 and 15; at D = 2 and 10 the examples'
    own targets), plain and whitened diag, against
    the twin: whole rows of positions, alpha, n_alpha, divergences and
    each chain's depth on at least 99.9% of the chains, a chain a lane in
    blocks of K4_THREADS[D] threads on the persistent grid."""
    t, pos, eps = _k4_user_case(case, kind, cuda)
    c, d = pos.shape
    got, grid, _, want, _ = _k4_against_twin(t, pos, eps)
    assert grid["threads"] == K4_THREADS[d]
    assert grid["blocks"] == min(grid["blocks_per_sm"] * grid["sms"],
                                 -(-c // grid["threads"]))
    assert _share(_rows_close(got[0], want[0])) >= 0.999
    for a, b in zip(got[1:4], want[1:4]):
        assert _share((a - b).abs() <= ATOL + RTOL * b.abs()) >= 0.999
    assert _share(got[4] == want[4]) >= 0.999
    assert int(got[4].max()) >= 2 and torch.isfinite(got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case, kind", [("gauss15", "whitened"),
                                        ("gauss16", "plain")])
def test_cuda_nuts_step_user_trees_match_the_twin(case, kind, cuda):
    """A tree that stopped early or late, or a row written to another
    chain, at D = 15 and 16 (64-thread blocks): each chain's depth and
    n_alpha equal the twin's exactly on at least 99.9% of the chains,
    every coordinate of the row with them, and the launch's leaves equal
    the twin's within 0.1%."""
    t, pos, eps = _k4_user_case(case, kind, cuda, seed=43)
    got, _, stats, want, details = _k4_against_twin(t, pos, eps, step=23)
    same = (got[4] == want[4]) & (got[2] == want[2])
    assert _share(same) >= 0.999
    assert _share(same & _rows_close(got[0], want[0])) >= 0.999
    twin = int(details["leaves"].sum())
    assert abs(int(stats[1]) - twin) <= 0.001 * twin
    # lane-iterations: at least one a leaf
    assert int(stats[1]) <= int(stats[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hand", "gauss16"])
def test_cuda_nuts_step_user_instances_are_the_same_under_any_grid(case,
                                                                 cuda):
    """Eight schools (D = 10, 128-thread blocks) and D = 16 (64-thread
    blocks): each chain's result depends on (key, step, chain) alone, so the
    resident grid, one block and one block an SM agree bit for bit."""
    t, pos, eps = _k4_user_case(case, "whitened", cuda, seed=44)
    grid = {}
    full = nuts_step(t, pos, eps, 10, 0xC0FFEE, 17, 10, grid=grid)
    for blocks in (1, grid["sms"]):
        other = nuts_step(t, pos, eps, 10, 0xC0FFEE, 17, 10, blocks=blocks)
        for a, b in zip(full, other):
            assert torch.equal(a, b), blocks


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["derived", "gauss16"])
def test_cuda_nuts_step_user_instances_on_two_streams_at_once(case, cuda):
    """D = 10 and 16: two launches in flight on two streams, each on half
    of the chains with its own counter, give the single-stream results bit
    for bit."""
    t, pos, eps = _k4_user_case(case, "whitened", cuda, seed=45)
    c = pos.shape[0]
    halves = (slice(0, c // 2), slice(c // 2, c))
    args = [(t, pos[sl], eps[sl], 10, 0xC0FFEE, 17, 10, sl.start)
            for sl in halves]
    want = [nuts_step(*a, blocks=8) for a in args]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda))
    got = []
    for _ in range(4):
        for a, stream in zip(args, streams):
            with torch.cuda.stream(stream):
                got.append(nuts_step(*a, blocks=8))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        for a, b in zip(out, want[i % 2]):
            assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_user_source_that_fails_nvcc_raises_with_its_output(cuda):
    bad = Target(logp=lambda p: -(p * p).sum(-1),
                 cuda_source="struct Density { not c++ };")
    x = torch.zeros((256, 3), device=cuda)
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*error"):
        NUTS(bad, x, 0.8, use_pallas="full")


@pytest.mark.cuda
def test_cuda_user_library_cache_reuses_an_unchanged_source(cuda):
    from mini_mcmc_torch.examples.eight_schools import CUDA_SOURCE
    from mini_mcmc_torch.ops.kernels import user_density

    first = user_density.lib_for(CUDA_SOURCE, 10, 0)
    path = user_density.library_path(CUDA_SOURCE, 10, 0)
    built = path.stat().st_mtime_ns
    assert user_density.lib_for(CUDA_SOURCE, 10, 0) is first
    assert user_density.build([(CUDA_SOURCE, 10, 0)]) == [path]
    assert path.stat().st_mtime_ns == built
    # another D or wrapper bits is another library
    assert user_density.library_path(CUDA_SOURCE, 10, 5) != path


# User forms in Kernels 5-8: each user instance against its twin


def _user_gaussian(d):
    """A Gaussian at D = ``d`` with standard deviations 0.5..2.5, a plain
    batch form (traced)."""
    s = torch.linspace(0.5, 2.5, d)
    return Target(
        logp=lambda x: -0.5 * torch.sum((x / s.to(x.device)) ** 2, dim=-1))


def _user_mh_case(which, c, cuda):
    from mini_mcmc_torch.examples import user_forms as F

    mean, cov = [0.5, -1.0], [[1.0, 0.3], [0.3, 2.0]]
    g = diffable_gaussian2d(mean, cov)
    d = {"gauss_d5": 5, "gauss_d16": 16}.get(which, 2)
    target, walk = {
        "traced": (F.gaussian2d_user(mean, cov, hand=False),
                   isotropic_gaussian_proposal(1.0)),
        "hand": (F.gaussian2d_user(mean, cov), F.isotropic_walk(1.0)),
        "scaled_walk": (g, F.scaled_walk([0.8, 1.3])),
        "rosenbrock": (F.rosenbrock_banana(),
                       isotropic_gaussian_proposal(0.5)),
        # past D = 3 Kernel 5's user instances take the accept's logf
        # before the proposal (mh_multistep.cuh, kLean): a user density
        # beside a user proposal at D = 5, and beside the walk at D = 16
        "gauss_d5": (_user_gaussian(5),
                     F.scaled_walk([0.4, 0.6, 0.8, 1.0, 1.2])),
        "gauss_d16": (_user_gaussian(16), isotropic_gaussian_proposal(0.5)),
    }[which]
    x = torch.from_numpy(_state(c, d, 31)[0])
    return target, walk, x, target.batch_logp(x)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["traced", "hand", "scaled_walk",
                                   "rosenbrock", "gauss_d5", "gauss_d16"])
def test_cuda_mh_user_instances_match_their_twins(cuda, which):
    """Kernel 5 with a user density (value-only library) or a user
    proposal against its twin for one K = 16 block, at D = 2, 5 and 16:
    the same accepts and positions within rtol 1e-5 on at least 99.9% of
    chains."""
    t, walk, x, lp = _user_mh_case(which, 8192, cuda)
    x, lp = x.to(cuda), lp.to(cuda)
    hk = torch.empty((16,) + tuple(x.shape), device=cuda)
    hp = torch.empty_like(hk)
    mh_multistep.user_launches = 0
    got = mh_multistep(t, walk, x, lp, 0x5EED_1701, 3, 16, hk)
    want = mh_multistep_plain(t, walk, x, lp, 0x5EED_1701, 3, 16, hp)
    assert mh_multistep.user_launches == 1
    moved_k = (hk != torch.cat([x[None], hk[:-1]])).any(2)
    moved_p = (hp != torch.cat([x[None], hp[:-1]])).any(2)
    near = ((hk - hp).abs() <= 1e-6 + 1e-5 * hp.abs()).all(2).all(0)
    assert _share((moved_k == moved_p).all(0) & near) >= 0.999
    assert _share(((got[1] - want[1]).abs()
                   <= 1e-6 + 1e-5 * want[1].abs())) >= 0.999


@pytest.mark.cuda
def test_cuda_user_copies_give_the_builtin_kernels_cube(cuda):
    """The hand Gaussian2D source and the user isotropic walk, copies of
    the built-ins' arithmetic, give the built-in instance's cube bit for
    bit from the same seed; so does the user mixture conditional."""
    from mini_mcmc_torch.examples import user_forms as F

    mean, cov = [0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]
    x = torch.from_numpy(_state(4096, 2, 5)[0]).to(cuda)
    cubes = [MetropolisHastings(t, p, x, use_pallas="full",
                                steps_per_call=16).seed(3).run(64)
             for t, p in ((gaussian2d(mean, cov),
                           isotropic_gaussian_proposal(1.0)),
                          (F.gaussian2d_user(mean, cov),
                           isotropic_gaussian_proposal(1.0)),
                          (gaussian2d(mean, cov), F.isotropic_walk(1.0)))]
    assert torch.equal(cubes[0], cubes[1]) and torch.equal(cubes[0],
                                                           cubes[2])
    z = torch.zeros((4096, 2), device=cuda)
    g = [GibbsSampler(cond, z, use_pallas="full", steps_per_call=8)
         .seed(3).run(64) for cond in (gaussian_mixture_conditional(*MIX),
                                       F.mixture_conditional(*MIX))]
    assert torch.equal(g[0], g[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 5, 16])
def test_cuda_pt_user_instances_match_their_twins(cuda, dim):
    """Kernel 8's user instance (the value-only library) at D = 1, 5, 16
    against its twin for one K = 16 block, the normals past D = 2 from
    draws p T + t: every field within rtol 1e-5 on 99.9% of chains."""
    from mini_mcmc_torch.examples import user_forms as F

    s = torch.linspace(0.5, 2.5, dim, device=cuda)
    t = (F.bimodal(0.7) if dim == 1 else Target(
        logp=lambda x: -0.5 * torch.sum((x / s) ** 2, dim=-1)))
    c, temps = 4096, 8
    gen = torch.Generator(device=cuda).manual_seed(dim)
    pos = torch.randn((temps, dim, c), generator=gen, device=cuda)
    lp = t.batch_logp(pos.permute(0, 2, 1).reshape(-1, dim)).reshape(
        temps, c).contiguous()
    sa = torch.zeros((temps - 1, c), device=cuda)
    lad = make_ladder(geometric_betas(temps, 0.01), 1.0, dim, cuda)
    hk = torch.empty((16, c, dim), device=cuda)
    hp = torch.empty_like(hk)
    args = (t, pos, lp, sa, 0, lad, 0x5EED_1702, 0, 16, 1)
    got = pt_multistep(*args, hk)
    want = pt_multistep_plain(*args, hp)

    def near(a, b):
        return (a - b).abs() <= 1e-6 + 1e-5 * b.abs()

    assert _share(near(got[0], want[0]).all(1).all(0)) >= 0.999
    assert _share(near(got[1], want[1]).all(0)) >= 0.999
    assert _share(near(hk, hp).all(2).all(0)) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["normal", "logistic_hand",
                                   "logistic_derived", "scaled",
                                   "transformed"])
def test_cuda_sep_user_instances_match_the_float64_twin(cuda, which):
    """Kernel 7's user coordinate functors (the traced standard normal,
    the logistic's hand source and derived functor, and the hand one
    scaled and transformed) at D = 4,096, 256 chains: one fused step
    against the float64 twin (_hold_step), and the validation probe."""
    from mini_mcmc_torch.examples import user_forms as F
    from mini_mcmc_torch.models import CoordinateTransform, interval
    from mini_mcmc_torch.models.base import validate_coord_dc

    d, c = 4096, 256
    sc = torch.logspace(-0.5, 0.5, d, device=cuda)
    t = {"normal": Target(logp=standard_normal().logp),
         "logistic_hand": F.logistic(sc),
         "logistic_derived": F.logistic(sc, hand=False)}.get(which)
    if which == "scaled":
        t = precondition_target(F.logistic(sc), Preconditioner(
            "diag", scale=sc.flip(0).contiguous()))
    elif which == "transformed":
        t = CoordinateTransform({i: interval(-24.0, 24.0) for i in range(d)},
                                dim=d).wrap(F.logistic(sc))
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((c, d), generator=gen, device=cuda)
    lp = t.batch_logp(x).float()
    validate_coord_dc(t, x)
    tables = (torch.cat([tt.to(cuda) for tt in t.sep_forms()[1]])
              if t.sep_forms()[1] else x.new_empty((0, d)))
    eps = torch.tensor([0.15], device=cuda)
    hmc_separable_step.user_launches = 0
    got = hmc_separable_step(t, x, lp, eps, 10, 0x5EED_1703, 2, tables)
    assert hmc_separable_step.user_launches == 1
    ref, tie, u = _sep_ref(t, x, lp, eps, 10, 0x5EED_1703, 2, tables)
    _hold_step(got, ref, tie, u, x)


@pytest.mark.cuda
def test_cuda_mh_and_pt_validate_in_the_value_only_library(cuda):
    """MH and tempering with a user density build the value-only library
    and validate there (need_grad=False): no dual-number library of
    Kernels 1-4 is built; a wrong source raises."""
    from mini_mcmc_torch.examples import user_forms as F
    from mini_mcmc_torch.ops.kernels import user_density

    t = F.bimodal(0.7, hand=True)
    x = torch.linspace(-10.0, 10.0, 256, device=cuda).reshape(-1, 1)
    MetropolisHastings(t, isotropic_gaussian_proposal(1.0), x,
                       use_pallas="full")
    ParallelTempering(t, x, use_pallas="full")
    forms = t.dc_forms(1, cuda)
    assert not user_density.library_path(forms.source, 1, 0).exists()
    wrong = Target(logp=t.logp, cuda_source=F.BIMODAL_SOURCE,
                   cuda_params=(-0.1, -2.0))
    with pytest.raises(ValueError, match="compiled logp"):
        ParallelTempering(wrong, x, use_pallas="full")


# -- float64 through Kernel 1, int32 user forms in Kernel 5 ----------------


def _f64_cases(cuda):
    from mini_mcmc_torch import CoordinateTransform, neal_funnel, positive
    from mini_mcmc_torch.examples import user_forms as F

    g = torch.Generator(device=cuda).manual_seed(64)

    def normal(d, scale, shift):
        return (torch.randn((2048, d), generator=g, device=cuda,
                            dtype=torch.float64) * scale + shift)

    diag = Preconditioner("diag", scale=torch.tensor(
        [0.9, 0.6, 0.4], dtype=torch.float64, device=cuda))
    gauss = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    return {
        "rosenbrock3": (rosenbrock_nd(), normal(3, 0.3, 0.8), 0.02),
        "gaussian2d_L1": (gauss, normal(2, 1.5, 0.0), 1.0),
        "whitened_diag": (precondition_target(rosenbrock_nd(), diag),
                          normal(3, 0.3, 1.0), 0.02),
        "positive": (CoordinateTransform({0: positive()}, dim=2).wrap(gauss),
                     normal(2, 0.7, 0.0), 0.2),
        "funnel4": (neal_funnel(3.0), normal(4, 0.8, 0.0), 0.1),
        "user_hand5": (F.rosenbrock_user(True), normal(5, 0.3, 0.8), 0.01),
        "user_traced5": (F.rosenbrock_user(False), normal(5, 0.3, 0.8),
                         0.01),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rosenbrock3", "gaussian2d_L1",
                                  "whitened_diag", "positive", "funnel4",
                                  "user_hand5", "user_traced5"])
def test_cuda_leapfrog_f64_matches_the_float64_twin(cuda, case):
    t, x, eps = _f64_cases(cuda)[case]
    n_lf = 1 if case.endswith("L1") else 8
    mom = torch.randn(x.shape, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda, dtype=torch.float64)
    _, g = t.batch_logp_and_grad(x)
    e = torch.tensor([eps], device=cuda, dtype=torch.float64)
    n, n64 = leapfrog_trajectory.launches, leapfrog_trajectory.f64_launches
    got = leapfrog_trajectory(t, x, mom, g, e, n_lf)
    assert (leapfrog_trajectory.launches - n,
            leapfrog_trajectory.f64_launches - n64) == (1, 1)
    want = leapfrog_trajectory_plain(t, x, mom, g, e[0], n_lf)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        scale = b.abs().amax(1, keepdim=True)
        assert bool(((a - b).abs() <= 1e-9 * scale).all()), float(
            ((a - b).abs() / scale).max())


@pytest.mark.cuda
def test_cuda_hmc_and_mala_run_float64_through_kernel1(cuda):
    x = torch.from_numpy(_state(1024, 3, 3)[0]).to(cuda).double()
    leapfrog_trajectory.f64_launches = 0
    calls = leapfrog_trajectory_plain.calls
    h = HMC(rosenbrock_nd(), x, 0.02, 16, use_pallas=True,
            jitter=0.3).seed(1)
    s = h.run(32, 0)
    assert s.dtype == torch.float64 and h.state.grad.dtype == torch.float64
    assert leapfrog_trajectory.f64_launches == 32
    ml = MALA(rosenbrock_nd(), x, step_size=0.1, use_pallas=True).seed(
        2).tuned(20)
    assert leapfrog_trajectory.f64_launches == 52
    assert ml.run(8).dtype == torch.float64
    assert leapfrog_trajectory_plain.calls == calls


@pytest.mark.cuda
def test_cuda_float64_validation_holds_the_double_instance(cuda):
    """HMC(use_pallas=True) on float64 states validates a user density's
    float64 library on the card at F64_DC_TOL: the hand Rosenbrock passes;
    a source whose 0.1f keeps the double instance at float precision is
    refused at float64 and still passes at float32."""
    from mini_mcmc_torch.examples import user_forms as F

    src = """
struct Density {
  __device__ __forceinline__ explicit Density(const float*) {}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    S s = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const S d = x[i] - 0.1f;
      s = s + d * d;
    }
    return -s / 2;
  }
};
"""
    x = torch.from_numpy(_state(256, 5, 5)[0]).to(cuda).double() * 0.3
    HMC(F.rosenbrock_user(True), x, 0.02, 8, use_pallas=True)
    shifted = Target(logp=lambda y: -0.5 * ((y - 0.1) ** 2).sum(dim=-1),
                     cuda_source=src)
    HMC(shifted, x.float(), 0.02, 8, use_pallas=True)
    with pytest.raises(ValueError, match="f-suffixed literal"):
        HMC(shifted, x, 0.02, 8, use_pallas=True)


@pytest.mark.cuda
def test_cuda_float64_raises_on_the_other_tiers(cuda):
    """Every fused tier but Kernel 1's refuses float64 at construction,
    naming what each tier takes; use_pallas=False takes it."""
    from mini_mcmc_torch.examples import user_forms as F

    x = torch.from_numpy(_state(256, 2, 4)[0]).to(cuda).double()
    g = diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    takes = "HMC/MALA use_pallas=True \\(Kernel 1\\): float32, float64"
    for make in (
            lambda: HMC(g, x, 0.1, 4, use_pallas="full"),
            lambda: MALA(g, x, 0.1, use_pallas="full"),
            lambda: NUTS(g, x, 0.8, use_pallas=True),
            lambda: NUTS(g, x, 0.8, use_pallas="full"),
            lambda: HMC(standard_normal(), x, 0.1, 4,
                        use_pallas="separable"),
            lambda: MetropolisHastings(F.rosenbrock_banana(),
                                       isotropic_gaussian_proposal(1.0), x,
                                       use_pallas="full"),
            lambda: GibbsSampler(gaussian_mixture_conditional(*MIX), x,
                                 use_pallas="full"),
            lambda: ParallelTempering(F.bimodal(0.7), x[:, :1],
                                      use_pallas="full")):
        with pytest.raises(ValueError, match=takes):
            make()
    assert HMC(g, x, 0.1, 4).run(2).dtype == torch.float64


def _int32_case(which):
    from mini_mcmc_torch.examples import user_forms as F
    from mini_mcmc_torch.models import binomial_target

    return {
        "hand": (F.poisson_user(4.0), random_walk_int_proposal(), 0),
        "traced": (binomial_target(10, 0.3), random_walk_int_proposal(0, 10),
                   5),
        "proposal": (poisson_target(4.0), F.int_walk(), 0),
    }[which]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["hand", "traced", "proposal"])
def test_cuda_mh_int32_user_instances_match_their_twins(cuda, which):
    """Kernel 5's int32 user instances against the twin for one K = 10
    block: positions equal, logp within rtol 1e-5, on every chain but
    0.1%; the hand Poisson and the user walk give the built-in's cube bit
    for bit."""
    t, walk, start = _int32_case(which)
    x = torch.full((8192, 1), start, dtype=torch.int32, device=cuda)
    x = x + torch.randint(0, 4, x.shape, device=cuda, dtype=torch.int32)
    lp = t.batch_logp(x)
    hk = torch.empty((10,) + tuple(x.shape), dtype=torch.int32, device=cuda)
    hp = torch.empty_like(hk)
    mh_multistep.user_launches = 0
    got = mh_multistep(t, walk, x, lp, 0x5EED_1801, 3, 10, hk)
    want = mh_multistep_plain(t, walk, x, lp, 0x5EED_1801, 3, 10, hp)
    assert mh_multistep.user_launches == 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    same = (hk == hp).all(2).all(0) & (got[0] == want[0]).all(1)
    near = (got[1] - want[1]).abs() <= 1e-6 + 1e-5 * want[1].abs()
    near |= torch.isneginf(got[1]) & torch.isneginf(want[1])
    assert _share(same) >= 0.999 and _share(near) >= 0.999
    if which != "traced":
        cubes = [MetropolisHastings(tt, ww, x, use_pallas="full",
                                    steps_per_call=10).seed(3).run(50, 20)
                 for tt, ww in ((t, walk), (poisson_target(4.0),
                                            random_walk_int_proposal()))]
        assert torch.equal(cubes[0], cubes[1])


@pytest.mark.cuda
def test_cuda_int32_forms_validate_in_their_library(cuda):
    """MH with int32 user forms validates on the card (the int32 value
    probe with the off-support rows, the int32 proposal probe); a wrong
    source raises."""
    from mini_mcmc_torch.examples import user_forms as F

    x = torch.arange(0, 11, dtype=torch.int32, device=cuda).reshape(-1, 1)
    for which in ("hand", "traced", "proposal"):
        t, walk, _ = _int32_case(which)
        MetropolisHastings(t, walk, x, use_pallas="full")
    wrong = Target(logp=poisson_target(4.0).logp,
                   cuda_source=F.POISSON_SOURCE.replace(
                       "- lam)", "- 1.01f * lam)"),
                   cuda_params=poisson_target(4.0).cuda_params)
    with pytest.raises(ValueError, match="compiled logp"):
        MetropolisHastings(wrong, random_walk_int_proposal(), x,
                           use_pallas="full")


# -- Kernel 1: rows in 16-byte pieces, the last logp with the last gradient


#: Kernel 1's built-in instances: (functor, D)
K1_BUILTINS = [("rosenbrock", 2), ("rosenbrock", 3), ("rosenbrock", 4),
               ("funnel", 2), ("funnel", 3), ("funnel", 4), ("gaussian", 2)]


def _k1_builtin(name, d):
    from mini_mcmc_torch import neal_funnel

    if name == "rosenbrock":
        return rosenbrock_nd(), 0.3, 0.9, 0.02
    if name == "funnel":
        return neal_funnel(3.0), 0.8, 0.0, 0.1
    return diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]), 1.5, \
        0.0, 0.3


def _k1_inputs(c, d, scale, shift, dtype, cuda, seed):
    """Positions, momenta, eps on the card, from a numpy seed."""
    g = np.random.default_rng(seed)
    pos = torch.from_numpy(g.standard_normal((c, d)) * scale + shift)
    mom = torch.from_numpy(g.standard_normal((c, d)))
    return pos.to(cuda, dtype), mom.to(cuda, dtype)


def _k1_agree(got, want):
    """Every output row within RTOL/ATOL of the twin's, the atol scaled to
    the row's largest entry (float32), or within 1e-9 of it (float64)."""
    for a, b in zip(got, want):
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        if a.dtype == torch.float64:
            scale = b.abs().amax(1, keepdim=True)
            assert bool(((a - b).abs() <= 1e-9 * scale).all())
        else:
            assert bool(_rows_close(a, b).all()), float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name, d", K1_BUILTINS)
def test_cuda_leapfrog_rows_ragged_and_offset(name, d, dtype, cuda):
    """Every built-in instance of Kernel 1 at float32 and float64, on
    ragged chain counts (1, 127, 129, 1,000: a block of one chain, a
    ragged last block on each side of 128), against its twin; and on a
    contiguous view at a one-row offset against the twin and, bit for bit,
    against the launch on a copy of it in its own allocation. Where a row
    is not a multiple of 16 bytes the view's base is off 16 bytes, so the
    view takes the element path and the copy the vector or staged one."""
    t, scale, shift, eps = _k1_builtin(name, d)
    e = torch.tensor([eps], device=cuda, dtype=dtype)
    row_bytes = d * (8 if dtype == torch.float64 else 4)
    for c in (1, 127, 129, 1000):
        pos, mom = _k1_inputs(c + 1, d, scale, shift, dtype, cuda, c + d)
        _, grad = t.batch_logp_and_grad(pos)
        x, m, g = pos[:c].contiguous(), mom[:c].contiguous(), \
            grad[:c].contiguous()
        got = leapfrog_trajectory(t, x, m, g, e, 8)
        _k1_agree(got, leapfrog_trajectory_plain(t, x, m, g, e[0], 8))
        # rows 1..c of a [c + 1, D] tensor: views at a one-row offset
        views = pos[1:], mom[1:], grad[1:]
        copies = [v.clone() for v in views]
        for v, k in zip(views, copies):
            assert v.is_contiguous() and k.data_ptr() % 16 == 0
            assert (v.data_ptr() % 16 != 0) == (row_bytes % 16 != 0)
        offset = leapfrog_trajectory(t, *views, e, 8)
        _k1_agree(offset, leapfrog_trajectory_plain(t, *views, e[0], 8))
        aligned = leapfrog_trajectory(t, *copies, e, 8)
        for a, b in zip(offset, aligned):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 7, 15])
def test_cuda_leapfrog_f64_user_staged_rows_ragged(d, cuda):
    """A traced user Rosenbrock at float64 and odd D (the rows staged
    through shared memory, 3 x 128 x 15 doubles a block at D = 15) on
    ragged chain counts, against the float64 twin at 1e-9 of the row's
    largest entry; and a view at a one-row offset (the element path) bit
    for bit the staged launch on a copy of it."""
    from mini_mcmc_torch.examples import user_forms as F

    t = F.rosenbrock_user(False)
    e = torch.tensor([0.01], device=cuda, dtype=torch.float64)
    for c in (129, 1000):
        pos, mom = _k1_inputs(c + 1, d, 0.3, 0.8, torch.float64, cuda, c + d)
        _, grad = t.batch_logp_and_grad(pos)
        x, m, g = pos[:c].clone(), mom[:c].clone(), grad[:c].clone()
        before = leapfrog_trajectory.f64_launches
        got = leapfrog_trajectory(t, x, m, g, e, 8)
        assert leapfrog_trajectory.f64_launches == before + 1
        _k1_agree(got, leapfrog_trajectory_plain(t, x, m, g, e[0], 8))
        views = pos[1:], mom[1:], grad[1:]
        assert all(v.data_ptr() % 16 != 0 for v in views)
        offset = leapfrog_trajectory(t, *views, e, 8)
        aligned = leapfrog_trajectory(t, *(v.clone() for v in views), e, 8)
        for a, b in zip(offset, aligned):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rosenbrock3_f32", "gaussian2_f32",
                                  "rosenbrock3_f64", "gaussian2_f64",
                                  "user_dual5", "user_hand10"])
def test_cuda_leapfrog_at_l0_returns_the_gradient_passed(case, cuda):
    """L = 0: positions, momenta and the gradient come back as passed, bit
    for bit (the gradient is not recomputed), the logp is the density at
    the positions (the twin's), for the built-ins and a user density whose
    gradient is a dual pass."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    dtype = torch.float64 if case.endswith("f64") else torch.float32
    if case.startswith("rosenbrock"):
        t, d = rosenbrock_nd(), 3
    elif case.startswith("gaussian"):
        t, d = _k1_builtin("gaussian", 2)[0], 2
    elif case == "user_dual5":
        t, d = _banded_gaussian(5), 5
    else:
        t, d = make_noncentered_target("hand"), 10
    pos, mom = _k1_inputs(1000, d, 0.5, 0.5, dtype, cuda, 3)
    # a gradient that is not the density's: L = 0 must not recompute it
    grad = torch.randn(pos.shape, device=cuda, dtype=dtype)
    e = torch.tensor([0.1], device=cuda, dtype=dtype)
    got = leapfrog_trajectory(t, pos, mom, grad, e, 0)
    assert torch.equal(got[0], pos) and torch.equal(got[1], mom)
    assert torch.equal(got[3], grad)
    _k1_agree(got[2:3], (t.batch_logp(pos),))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gauss1", "gauss3", "gauss5", "hand10",
                                  "derived10", "gauss16",
                                  "gauss5_whitened"])
def test_cuda_leapfrog_user_dims_match_their_twin(case, cuda):
    """User densities at float32 and D = 1, 3, 5, 10 and 16 (a row of one
    scalar, rows element by element at D = 3, 5 and 10, 16-byte vectors
    at D = 16): the traced banded Gaussians (at D = 1 its neighbour sum
    is empty, an S(0) in the generated C++) and eight schools' hand and
    derived forms, each gradient then logp; all four outputs, logp
    included, against the twin on ragged chain counts."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    if case.startswith("gauss"):
        d = int(case[5:].split("_")[0])
        t = _banded_gaussian(d)
    else:
        d = 10
        t = make_noncentered_target(case[:-2])
    if case.endswith("whitened"):
        t = precondition_target(t, Preconditioner(
            "diag", scale=torch.linspace(0.5, 2.0, d, device=cuda)))
    e = torch.tensor([0.05], device=cuda)
    for c in (129, 1000):
        pos, mom = _k1_inputs(c, d, 0.5, 0.0, torch.float32, cuda, c + d)
        _, grad = t.batch_logp_and_grad(pos)
        before = leapfrog_trajectory.user_launches
        got = leapfrog_trajectory(t, pos, mom, grad, e, 8)
        assert leapfrog_trajectory.user_launches == before + 1
        _k1_agree(got, leapfrog_trajectory_plain(t, pos, mom, grad, e[0], 8))


# ---------------------------------------------------------------------------
# Chain offsets (chain0) and the one-rank chain mesh
# ---------------------------------------------------------------------------

#: a shard's first global chain, off every warp, block and cluster boundary
CHAIN0 = 1_000_003


def _split_cases(dev, c=4096):
    """Kernels 2-8 on ``c`` chains (Kernel 7: 256 chains x D = 512, its
    rows indexed alone; Kernel 8: ``c`` chains x 8 rungs): name ->
    launch(lo, hi, chain0) -> [(output, its chain axis)] over chains
    ``[lo, hi)`` as global chains chain0..."""
    gen = torch.Generator(device=dev).manual_seed(5151)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rosen = rosenbrock_nd()
    x2 = randn(c, 3) * 0.3 + 0.9
    lp2, g2 = rosen.batch_logp_and_grad(x2)
    eps2 = torch.full((4,), 0.01, device=dev)
    gauss = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x3 = randn(c, 2) * 1.5
    m3 = randn(c, 2)
    lp3, g3 = gauss.batch_logp_and_grad(x3)
    j0 = lp3 - 0.5 * (m3 * m3).sum(1)
    logu = j0 - torch.empty_like(j0).exponential_(generator=gen)
    u = torch.rand((3, c), generator=gen, device=dev)
    v = torch.where(u[0] < 0.5, -1, 1).to(torch.int32)
    eps3 = 0.3 + 0.9 * u[2]
    g2d = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    walk = isotropic_gaussian_proposal(1.0)
    lp5 = g2d.batch_logp(x3)
    cond = gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5)
    x6 = torch.stack([x3[:, 0], (u[1] < 0.5).float()], dim=1)
    sn = standard_normal()
    x7 = randn(256, 512)
    lp7 = sn.batch_logp(x7)
    mix = _mixture()
    x8 = torch.where(torch.rand((8, 1, c), generator=gen, device=dev) < 0.7,
                     8.0, -8.0) + 0.5 * randn(8, 1, c)
    lp8 = mix.batch_logp(x8.permute(0, 2, 1).reshape(-1, 1)).reshape(8, c)
    sa8 = torch.zeros((7, c), device=dev)
    lad = make_ladder(geometric_betas(8, 0.01), 1.0, 1, dev)

    def hist(k, n, d):
        return torch.empty((k, n, d), device=dev)

    def k2(lo, hi, c0, plain=False):
        h = hist(4, hi - lo, 3)
        fn = hmc_multistep_plain if plain else hmc_multistep
        o = fn(rosen, x2[lo:hi], lp2[lo:hi], g2[lo:hi], eps2, 6, 1234, 3, h,
               chain0=c0)
        return [(o[0], 0), (o[1], 0), (o[2], 0), (h, 1)]

    def k3(lo, hi, c0, plain=False):
        fn = subtree_plain if plain else subtree
        r = fn(gauss, x3[lo:hi], m3[lo:hi], g3[lo:hi], logu[lo:hi],
               v[lo:hi], 4, eps3[lo:hi], j0[lo:hi], u[1, lo:hi] < 0.9,
               (0x1234567, -0x7654321), 10, chain0=c0)
        return [(t, 0) for t in r]

    def k4(lo, hi, c0):
        return [(t, 0) for t in nuts_step(gauss, x3[lo:hi], eps3[lo:hi], 10,
                                          77, 9, 10, c0)]

    def k5(lo, hi, c0):
        h = hist(8, hi - lo, 2)
        o = mh_multistep(g2d, walk, x3[lo:hi], lp5[lo:hi], 88, 2, 8, h,
                         chain0=c0)
        return [(o[0], 0), (o[1], 0), (h, 1)]

    def k6(lo, hi, c0):
        h = hist(8, hi - lo, 2)
        o = gibbs_multistep(cond, x6[lo:hi], 66, 1, 8, h, chain0=c0)
        return [(o, 0), (h, 1)]

    def k7(lo, hi, c0):  # rows of x7's 256
        return [(t, 0) for t in hmc_separable_step(
            sn, x7[lo:hi], lp7[lo:hi], torch.tensor([0.1], device=dev), 8,
            55, 4, x7.new_empty((0, 512)), chain0=c0)]

    def k8(lo, hi, c0, plain=False):
        h = hist(8, hi - lo, 1)
        fn = pt_multistep_plain if plain else pt_multistep
        o = fn(mix, x8[..., lo:hi].contiguous(), lp8[:, lo:hi].contiguous(),
               sa8[:, lo:hi].contiguous(), 1, lad, 99, 5, 8, 1, h, chain0=c0)
        return [(o[0], 2), (o[1], 1), (o[2], 1), (h, 1)]

    return dict(k2=k2, k3=k3, k4=k4, k5=k5, k6=k6, k7=k7, k8=k8)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3", "k4", "k5", "k6", "k7",
                                    "k8"])
@pytest.mark.parametrize("split", ["half", "odd"])
def test_cuda_split_launches_equal_one_launch(cuda, kernel, split):
    """Chains [0, s) at chain0 = 0 and [s, C) at chain0 = s give one
    launch's outputs over [0, C) bit for bit: the offset acts on the
    global chain index alone, never on the thread layout (Kernel 8's
    chains a warp, Kernel 4's persistent grid, Kernel 7's clusters)."""
    c = 256 if kernel == "k7" else 4096
    s = c // 2 if split == "half" else (c // 3) | 1
    launch = _split_cases(cuda)[kernel]
    full = launch(0, c, 0)
    lo, hi = launch(0, s, 0), launch(s, c, s)
    for (f, ax), (a, _), (b, _) in zip(full, lo, hi):
        assert torch.equal(torch.cat([a, b], dim=ax), f)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3", "k8"])
def test_cuda_chain0_launch_matches_twin(cuda, kernel):
    """Kernels 2, 3 and 8 at chain0 = 1,000,003 against their twins at the
    same offset, by each kernel's own test's criteria: Kernel 2's rows,
    state and accepts per chain within RTOL/ATOL on >= 99.9% of chains;
    Kernel 3's counts and flags equal on >= 99.9%; Kernel 8 equal to its
    twin on >= 99.9% (the mixture rounds as the twin)."""
    launch = _split_cases(cuda)[kernel]
    got = [t for t, _ in launch(0, 4096, CHAIN0)]
    want = [t for t, _ in launch(0, 4096, CHAIN0, plain=True)]
    torch.cuda.synchronize()
    if kernel == "k2":
        def near(a, b):
            return (a - b).abs() <= ATOL + RTOL * b.abs()

        ok = (near(got[3], want[3]).all(2).all(0)
              & near(got[0], want[0]).all(1) & near(got[1], want[1]))
    elif kernel == "k3":
        ok = ((got[6] == want[6]) & (got[7] == want[7])
              & (got[9] == want[9]) & (got[10] == want[10]))
    else:
        ok = ((got[0] == want[0]).all(1).all(0) & (got[1] == want[1]).all(0)
              & (got[3] == want[3]).all(2).all(0))
    assert _share(ok) >= 0.999
    # and the offset moved the draws: chain0 = 0 gives other outputs (for
    # Kernel 3 its proposals: the merges' uniforms move, its ends do not)
    other = [t for t, _ in launch(0, 4096, 0)]
    assert any(not torch.equal(a, b) for a, b in zip(other, got))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["hmc_full", "pt_full", "nuts_true"])
def test_cuda_one_rank_mesh_runs_equal_unsharded(cuda, tier):
    """Through a one-rank NCCL chain mesh (``parallel.chain_mesh()``) the
    sampler's cube is the unsharded run's bit for bit, as a DTensor
    sharded on its chain axis, with the same kernel launches."""
    from mini_mcmc_torch.parallel import chain_mesh, shard_sampler_state

    def make():
        if tier == "hmc_full":
            return HMC(rosenbrock_nd(), torch.ones((4096, 3), device=cuda),
                       0.02, 8, use_pallas="full", steps_per_call=8).seed(4)
        if tier == "pt_full":
            return ParallelTempering(
                _mixture(), torch.full((4096, 1), -8.0, device=cuda),
                betas=geometric_betas(8, 0.01), steps_per_call=8,
                use_pallas="full").seed(5)
        return NUTS(diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0],
                                                     [2.0, 3.0]]),
                    torch.zeros((1024, 2), device=cuda), 0.8, max_depth=4,
                    use_pallas=True).seed(6)

    counter = {"hmc_full": hmc_multistep, "pt_full": pt_multistep,
               "nuts_true": subtree}[tier]
    a, b = make(), make()
    b.state = shard_sampler_state(chain_mesh(), b.state)
    n = counter.launches
    want = a.run(16, 8)
    launches = counter.launches - n
    got = b.run(16, 8)
    assert counter.launches - n == 2 * launches > 0
    assert type(got).__name__ == "DTensor"
    assert torch.equal(got.to_local(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["standard_normal", "sigma_table"])
@pytest.mark.parametrize("d0", [2500, 5000, 7500])
def test_cuda_separable_trajectory_at_a_d_slice_matches_twin(cuda, which,
                                                             d0):
    """Kernel 7's trajectory form on the D-slice ``[d0, 10,000)`` of a
    state, its momenta drawn as global coordinates ``d0 ..``, against the
    float64 twin at the same ``d0``: positions per chain within RTOL/ATOL
    and the three sums at rtol 1e-5 on >= 99.9% of 1,024 chains; the same
    slice at ``d0 = 0`` draws other momenta."""
    c, d = 1024, 10_000
    t, x, _, tables = _sep_step_case(which, d, c, cuda, 61)
    xs, ts = x[:, d0:].contiguous(), tables[:, d0:].contiguous()
    eps = torch.tensor([0.01 if which == "sigma_table" else 0.1],
                       device=cuda)
    n = hmc_separable.launches
    got = hmc_separable(t, xs, eps, 10, 0x5EED_D0, 5, ts, chain0=3, d0=d0,
                        n_dim=d)
    assert hmc_separable.launches == n + 1
    ref = hmc_separable_plain(t, xs.double(), eps.double(), 10, 0x5EED_D0,
                              5, ts.double(), chain0=3, d0=d0)
    torch.cuda.synchronize()
    near = ((got[0] - ref[0]).abs() <= ATOL + RTOL * ref[0].abs()).all(1)
    assert _share(near) >= 0.999
    for g, r in zip(got[1:4], ref[1:4]):
        assert _share((g.double() - r).abs() <= 1e-5 * r.abs()) >= 0.999
    at0 = hmc_separable(t, xs, eps, 10, 0x5EED_D0, 5, ts, chain0=3)
    assert not torch.equal(at0[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sigma_table", "scaled_sigma_table",
                                   "mixed_sigma_scaled"])
@pytest.mark.parametrize("d", [10_000, 65_536])
@pytest.mark.parametrize("n_slices", [2, 4])
def test_cuda_separable_split_launches_equal_one_launch(cuda, which, d,
                                                        n_slices):
    """A state split into 2 or 4 D-slices, each launched at its ``d0``
    with its columns of the tables (the scale, a transform's masks) and
    of the bijector table: the slices' positions concatenated equal one
    launch's bit for bit (at D = 65,536 past 16 tiles too), their summed
    energies within rtol 1e-5 of the one launch's; a ``d0`` that is no
    multiple of 4 raises."""
    c = 1024
    if which == "mixed_sigma_scaled":
        t, x, _, tables = _sep_transformed("mixed_sigma", d, c, cuda, 62,
                                           scaled=True)
    else:
        t, x, _, tables = _sep_step_case(which, d, c, cuda, 62)
    eps = torch.tensor([0.01], device=cuda)
    whole = hmc_separable(t, x, eps, 10, 0x5EED_5A, 8, tables)
    w = d // n_slices
    parts = [hmc_separable(t, x[:, d0:d0 + w].contiguous(), eps, 10,
                           0x5EED_5A, 8, tables[:, d0:d0 + w].contiguous(),
                           d0=d0, n_dim=d) for d0 in range(0, d, w)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([p[0] for p in parts], dim=1), whole[0])
    for i in (1, 2, 3):
        total = sum(p[i].double() for p in parts)
        assert bool(((total - whole[i].double()).abs()
                     <= 1e-5 * whole[i].double().abs()).all())
    with pytest.raises(ValueError, match="multiple of 4"):
        hmc_separable(t, x[:, 2:].contiguous(), eps, 10, 0x5EED_5A, 8,
                      tables[:, 2:].contiguous(), d0=2, n_dim=d)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["separable", False])
def test_cuda_one_by_one_state_mesh_runs_equal_unsharded(cuda, tier):
    """Through a one-rank ``chain_state_mesh(1, 1)`` with the state
    dimension split (``shard_state_dim=True``), the separable and the
    lockstep tiers' cubes are the unsharded runs' bit for bit, D on the
    state axis, with the same Kernel 7 launches (a state axis of one rank
    takes the fused form)."""
    from mini_mcmc_torch.parallel import chain_state_mesh, shard_sampler_state

    def make():
        return HMC(standard_normal(), torch.randn(
            (1024, 10_000), generator=torch.Generator().manual_seed(8)).to(
                cuda), 0.1, 10, use_pallas=tier).seed(8)

    a, b = make(), make()
    b.state = shard_sampler_state(chain_state_mesh(1, 1), b.state,
                                  shard_state_dim=True)
    n = hmc_separable_step.launches
    want = a.run(8, 8)
    launches = hmc_separable_step.launches - n
    got = b.run(8, 8)
    assert hmc_separable_step.launches - n == 2 * launches
    assert launches == (16 if tier else 0)
    assert tuple(str(p) for p in got.placements) == ("S(0)", "S(2)")
    assert torch.equal(got.to_local(), want)
