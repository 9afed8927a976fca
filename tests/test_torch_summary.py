"""mini_mcmc_torch.diagnostics' ``summary`` and its quantiles against the
JAX package on the same numpy cubes.

Tolerances: mean, sd and quantiles at rtol 1e-5 (float32 reductions in
another order); the ESS, the R-hat and the MCSEs, which integrate the ESS,
at tests/test_torch_stats.py's ``ESS_RTOL`` and ``RHAT_RTOL``. The
quantile helper equals ``jnp.quantile`` (the suite runs JAX with x64, so
its interpolation is float64 as the helper's is) above the 2**24 draws
at which ``torch.quantile`` raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch import summary
from mini_mcmc_torch.diagnostics import _quantile
from mini_mcmc_tpu import diagnostics as jdiag

torch.set_num_threads(1)

RHAT_RTOL, ESS_RTOL = 1e-5, 1e-3
LEVELS = (0.0, 0.05, 0.25, 0.5, 0.75, 0.95, 1.0)


def _ar1_cube(c, n, p, seed, phi=0.6):
    g = np.random.default_rng(seed)
    x = np.zeros((c, n, p))
    e = g.standard_normal((c, n, p))
    x[:, 0] = e[:, 0]
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    x += 0.3 * g.standard_normal((c, 1, p))
    return x.astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("n,time_major", [(80, False), (300, True)])
def test_summary_matches_jax(n, time_major):
    cube = _ar1_cube(8, n, 3, seed=n)
    if time_major:
        cube = np.ascontiguousarray(cube.transpose(1, 0, 2))
    names = ("a", "b", "c")
    got = summary(torch.from_numpy(cube), quantiles=LEVELS,
                  param_names=names, time_major=time_major)
    want = jdiag.summary(jnp.asarray(cube), quantiles=LEVELS,
                         param_names=names, time_major=time_major)
    assert got.names == want.names and got.q_levels == want.q_levels
    assert got.quantiles.shape == (len(LEVELS), 3)
    for f in ("mean", "sd", "quantiles"):
        _close(getattr(got, f), getattr(want, f), 1e-5)
    for f in ("ess_bulk", "ess_tail", "mcse_mean", "mcse_sd"):
        _close(getattr(got, f), getattr(want, f), ESS_RTOL)
    _close(got.rhat, want.rhat, RHAT_RTOL)
    got_lines, want_lines = str(got).splitlines(), str(want).splitlines()
    assert got_lines[0] == want_lines[0]  # the header
    assert [ln.split()[0] for ln in got_lines[1:]] == list(names)


def test_summary_defaults_and_errors():
    cube = torch.from_numpy(_ar1_cube(4, 40, 2, seed=1))
    s = summary(cube)
    assert s.names == ("x0", "x1") and s.q_levels == (0.05, 0.5, 0.95)
    assert "q5" in str(s) and "ess_bulk" in str(s)
    with pytest.raises(ValueError, match="3-D"):
        summary(cube[0])
    with pytest.raises(ValueError, match="param_names"):
        summary(cube, param_names=("only",))


def test_mcse_sd_at_no_information():
    # ess <= 1 clamps to just above 1: mcse_sd ~ sqrt(e - 1) sd, no NaN
    cube = np.repeat(_ar1_cube(2, 1, 1, seed=3), 4, axis=1)
    cube[:, :, 0] += np.arange(4, dtype=np.float32)[None, :] * 1e-3
    got = summary(torch.from_numpy(cube))
    want = jdiag.summary(jnp.asarray(cube))
    _close(got.mcse_sd, want.mcse_sd, ESS_RTOL)


def test_quantile_matches_jnp():
    g = np.random.default_rng(5)
    pm = g.standard_normal((4, 1001)).astype(np.float32)
    pm[2, 17] = np.nan  # a row with a NaN gives NaN, as in jnp
    got = _quantile(torch.from_numpy(pm), LEVELS)
    want = jnp.quantile(jnp.asarray(pm), jnp.asarray(LEVELS), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scalar = _quantile(torch.from_numpy(pm), 0.3)
    assert scalar.shape == (4,)
    np.testing.assert_array_equal(
        scalar.numpy(), np.asarray(jnp.quantile(jnp.asarray(pm), 0.3,
                                                axis=1)))


def test_quantile_above_the_torch_quantile_cap():
    # 2**24 + 1 draws of one parameter (67 MB): torch.quantile raises
    pm = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 2**24 + 1)).astype(np.float32))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(pm, 0.5, dim=1)
    levels = (0.05, 0.5, 0.95, 1.0)
    want = jnp.quantile(jnp.asarray(pm.numpy()), jnp.asarray(levels), axis=1)
    np.testing.assert_array_equal(_quantile(pm, levels).numpy(),
                                  np.asarray(want))


def test_summary_above_the_cap():
    # 64 chains x (2**18 + 1) draws: 16,777,280 draws per parameter, past
    # the 2**24 at which torch.quantile refused rank_normalized_diagnostics
    # and summary before _quantile replaced it (summary runs both)
    g = np.random.default_rng(2)
    cube = torch.from_numpy(g.standard_normal((64, 2**18 + 1, 1)).astype(
        np.float32))
    s = summary(cube, quantiles=(0.5,))
    for f in ("mean", "sd", "quantiles", "ess_bulk", "ess_tail", "rhat",
              "mcse_sd"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    assert abs(float(s.quantiles[0, 0])) < 1e-3
    assert abs(float(s.rhat[0]) - 1.0) < 1e-3
