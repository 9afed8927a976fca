"""The hand-written CUDA kernels against their plain PyTorch twins, on a
CUDA device. Marked ``cuda`` and skipped without one. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-3, atol 1e-4 (the kernel contracts multiply-adds into
FMAs; the twin rounds each operation), on short trajectories from states
near the Rosenbrock mode, where rounding differences do not grow.
"""

import numpy as np
import pytest
import torch

from mini_mcmc_torch import HMC
from mini_mcmc_torch.models import Target, rosenbrock_nd
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
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
    plain_target = Target(logp=rosenbrock_nd().logp)
    x = torch.ones((128, 3), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        HMC(plain_target, x, 0.02, 4, use_pallas="full")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        HMC(plain_target, x, 0.02, 4, use_pallas=True)
    HMC(plain_target, x, 0.02, 4).run(2)  # the plain tier needs no functor
