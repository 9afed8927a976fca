"""mini_mcmc_torch.stats and .diagnostics against the JAX package on the
same cubes, at n <= 100 (brute-force autocovariance) and n > 100 (FFT).

Tolerances: R-hat rtol 1e-5 (moment sums in another reduction order);
ESS rtol 1e-3 (FFT round-off differs between the libraries, and the Geyer
sum integrates it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch import diagnostics, stats
from mini_mcmc_torch import rank_normalized_diagnostics, split_rhat_mean_ess
from mini_mcmc_tpu import diagnostics as jdiag
from mini_mcmc_tpu import stats as jstats

torch.set_num_threads(1)

RHAT_RTOL, ESS_RTOL = 1e-5, 1e-3


def _ar1_cube(c, n, p, seed, phi=0.6):
    """``[C, N, P]`` AR(1) chains with per-chain offsets (so R-hat moves)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((c, n, p))
    e = rng.standard_normal((c, n, p))
    x[:, 0] = e[:, 0]
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    x += 0.3 * rng.standard_normal((c, 1, p))
    return x.astype(np.float32)


# n = 64 and 101 split to n' = 32 and 50 (brute force; 101 drops the middle
# draw); n = 400 splits to 200 (FFT)
@pytest.mark.parametrize("n,time_major", [(64, False), (101, True),
                                          (400, False), (400, True)])
def test_split_rhat_mean_ess_matches_jax(n, time_major):
    cube = _ar1_cube(12, n, 3, seed=n)
    if time_major:
        cube = np.ascontiguousarray(cube.transpose(1, 0, 2))
    want_r, want_e = jstats.split_rhat_mean_ess(
        jnp.asarray(cube, jnp.float32), time_major=time_major)
    r, e = split_rhat_mean_ess(torch.from_numpy(cube), time_major=time_major)
    assert r.dtype == torch.float32 and e.shape == (3,)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), rtol=RHAT_RTOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(want_e), rtol=ESS_RTOL)


def test_layouts_and_chunking_agree(monkeypatch):
    cube = torch.from_numpy(_ar1_cube(10, 150, 2, seed=1))
    r, e = split_rhat_mean_ess(cube)
    r_tm, e_tm = split_rhat_mean_ess(cube.transpose(0, 1).contiguous(),
                                     time_major=True)
    monkeypatch.setattr(stats, "_AUTOCOV_CHUNK", 6)  # 3 chains per block
    r_ch, e_ch = split_rhat_mean_ess(cube.transpose(0, 1), time_major=True)
    r_cm, e_cm = split_rhat_mean_ess(cube)
    for got_r, got_e in ((r_tm, e_tm), (r_ch, e_ch), (r_cm, e_cm)):
        np.testing.assert_allclose(got_r.numpy(), r.numpy(), rtol=RHAT_RTOL)
        np.testing.assert_allclose(got_e.numpy(), e.numpy(), rtol=ESS_RTOL)


@pytest.mark.parametrize("n", [40, 300])
def test_autocov_matches_jax(n):
    x = _ar1_cube(1, n, 3, seed=2)[0]
    want_bf = np.asarray(jstats.autocov_bf(jnp.asarray(x)))
    want_fft = np.asarray(jstats.autocov_fft(jnp.asarray(x)))
    got_bf = stats.autocov_bf(torch.from_numpy(x)).numpy()
    got_fft = stats.autocov_fft(torch.from_numpy(x)).numpy()
    scale = np.abs(want_bf).max()
    np.testing.assert_allclose(got_bf, want_bf, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(got_fft, want_fft, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got_fft, got_bf, rtol=1e-3, atol=1e-4 * scale)
    dispatch = stats.autocov(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(dispatch, got_bf if n <= 100 else got_fft)


def test_geyer_tau_matches_jax():
    rng = np.random.default_rng(3)
    rho = np.concatenate([np.ones((1, 4)), rng.uniform(-0.2, 0.9, (9, 4))])
    rho = rho.astype(np.float32)
    want = np.asarray(jstats._geyer_tau(jnp.asarray(rho)))
    got = stats._geyer_tau(torch.from_numpy(rho)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert stats._geyer_tau(torch.ones((1, 2))).tolist() == [-1.0, -1.0]


def test_inverted_split_rhat_quirk_is_kept():
    # chains with different means: the reference's sqrt(W / var) drops
    # below 1 where the standard orientation would exceed it
    cube = _ar1_cube(8, 64, 1, seed=4)
    cube += np.arange(8, dtype=np.float32)[:, None, None]
    r, _ = split_rhat_mean_ess(torch.from_numpy(cube))
    assert float(r[0]) < 0.5


@pytest.mark.parametrize("n,time_major", [(64, False), (240, True)])
def test_rank_normalized_diagnostics_matches_jax(n, time_major):
    cube = _ar1_cube(8, n, 3, seed=5 + n)
    cube[:, :, 2] = np.exp(cube[:, :, 2])  # a skewed parameter
    if time_major:
        cube = np.ascontiguousarray(cube.transpose(1, 0, 2))
    want = jdiag.rank_normalized_diagnostics(jnp.asarray(cube, jnp.float32),
                                             time_major=time_major)
    got = rank_normalized_diagnostics(torch.from_numpy(cube),
                                      time_major=time_major)
    assert isinstance(got, diagnostics.ModernDiagnostics)
    for name in ("rhat", "rhat_bulk", "rhat_folded"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RHAT_RTOL, err_msg=name)
    for name in ("ess_bulk", "ess_tail"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=ESS_RTOL, err_msg=name)


def test_rank_normalized_diagnostics_rejects_non_cubes():
    with pytest.raises(ValueError, match="3-D"):
        rank_normalized_diagnostics(torch.zeros((4, 5)))
