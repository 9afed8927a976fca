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
every chain.
"""

import numpy as np
import pytest
import torch

from mini_mcmc_torch import HMC, NUTS
from mini_mcmc_torch.models import Target, diffable_gaussian2d, rosenbrock_nd
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.nuts_full import nuts_step, nuts_step_plain
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree, subtree_plain

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
    plain_target = Target(logp=rosenbrock_nd().logp)
    x = torch.ones((128, 3), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        HMC(plain_target, x, 0.02, 4, use_pallas="full")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        HMC(plain_target, x, 0.02, 4, use_pallas=True)
    HMC(plain_target, x, 0.02, 4).run(2)  # the plain tier needs no functor


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
@pytest.mark.parametrize("j", [0, 2, 4])
def test_cuda_subtree_matches_plain(cuda, j):
    c = 8192
    pos, mom, eps = _nuts_state(c, seed=20 + j)
    t = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    x, m = torch.from_numpy(pos).to(cuda), torch.from_numpy(mom).to(cuda)
    e = torch.from_numpy(eps).to(cuda)
    lp, g = t.batch_logp_and_grad(x)
    joint0 = lp - 0.5 * (m * m).sum(1)
    gen = torch.Generator(device=cuda).manual_seed(j)
    logu = joint0 - torch.empty(c, device=cuda).exponential_(generator=gen)
    v = torch.where(torch.rand(c, generator=gen, device=cuda) < 0.5, -1,
                    1).to(torch.int32)
    active = torch.rand(c, generator=gen, device=cuda) < 0.75
    args = (t, x, m, g, logu, v, j, e, joint0, active, (12345, -6789), 10)
    n = subtree.launches
    got = subtree(*args)
    assert subtree.launches == n + 1
    want = subtree_plain(*args)
    torch.cuda.synchronize()
    same = ((got.n == want.n) & (got.s == want.s)
            & (got.n_alpha == want.n_alpha) & (got.diverged == want.diverged))
    assert _share(same) >= 0.999
    near = (got.alpha - want.alpha).abs() <= ATOL + RTOL * want.alpha.abs()
    assert _share(same & near) >= 0.999
    s = same & want.s
    for a, b in zip(got[:6], want[:6]):
        ok = ((a - b).abs() <= ATOL + RTOL * b.abs())
        ok = ok.reshape(c, -1).all(1) | ~s
        assert _share(ok) >= 0.999


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
    assert _share(got[4] == want[4]) >= 0.999  # warp depths
    assert int(got[4].max()) >= 2


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
    with pytest.raises(ValueError, match="ROADMAP.md"):
        NUTS(plain, x, 0.8, use_pallas="full")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        NUTS(plain, x, 0.8, use_pallas=True)
    g = diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(ValueError, match="float32"):
        NUTS(g, x.double(), 0.8, use_pallas="full")
    with pytest.raises(ValueError, match="max_depth"):
        NUTS(g, x, 0.8, max_depth=12, use_pallas="full")
    out = NUTS(g, x, 0.8, use_pallas="full").seed(1).run(8, 8)
    assert out.is_cuda and torch.isfinite(out).all()
