"""The streaming tracker and the run summaries of mini_mcmc_torch.stats
against the JAX package on the same numpy inputs.

Tolerances: the tracker, ``tracker_rhat`` and ``collect_rhat`` at rtol
1e-6 over at most 64 rows and 1e-5 over 1,000 (float32 sums in another
order, each row's rounding carried into the running moments);
``tracker_update_rows`` against K calls of ``tracker_update`` at rtol 1e-5
and, on ``p_accept``, atol 1e-6 (a closed form against a sequential fold);
``basic_stats``' min, median and max exactly (selections), its float32
mean and std at rtol 1e-6 (the JAX side's last bit follows XLA's
summation order); ``run_stats`` and ``ess_from_chainstats`` at
tests/test_torch_stats.py's ``RHAT_RTOL`` and ``ESS_RTOL``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch import stats
from mini_mcmc_tpu import stats as jstats

torch.set_num_threads(1)

RHAT_RTOL, ESS_RTOL = 1e-5, 1e-3
CPU = dict(device="cpu")


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _rows(n, c, p, seed, stay=0.3):
    """``[n, C, P]`` float32 rows of a random walk in which each chain
    keeps its last row with probability ``stay`` (a rejected step)."""
    g = np.random.default_rng(seed)
    x = np.zeros((n, c, p), np.float32)
    cur = g.standard_normal((c, p)).astype(np.float32)
    for i in range(n):
        move = g.random(c) >= stay
        cur = np.where(move[:, None], cur + g.standard_normal(
            (c, p)).astype(np.float32), cur)
        x[i] = cur
    return x


def _fold_both(rows):
    """The port's and the JAX package's tracker after each row in turn."""
    n, c, p = rows.shape
    t = stats.tracker_init(c, p, **CPU)
    jt = jstats.tracker_init(c, p)
    for i in range(n):
        t = stats.tracker_update(t, torch.from_numpy(rows[i]))
        jt = jstats.tracker_update(jt, jnp.asarray(rows[i]))
    return t, jt


def _assert_trackers_close(t, jt, rtol):
    assert t.n == int(jt.n)
    for f in ("p_accept", "last_state", "mean", "mean_sq",
              "p_accept_chains"):
        _close(getattr(t, f), getattr(jt, f), rtol)
    _close(stats.tracker_stats(t).sm2, jstats.tracker_stats(jt).sm2, rtol)
    _close(stats.tracker_rhat(t), jstats.tracker_rhat(jt), rtol)
    _close(stats.tracker_max_rhat(t), jstats.tracker_max_rhat(jt), rtol)


# stats.rs:703-720 and :739-752, the golden values of tests/test_stats.py
@pytest.mark.parametrize("data0,data1,expected", [
    ([[0.0, 1.0, 0.0, 1.0], [1.0, 2.0, 0.0, 2.0], [0.0, 0.0, 0.0, 2.0]],
     [[1.0, 2.0, 2.0, 0.0], [1.0, 1.0, 1.0, 1.0], [0.0, 1.0, 0.0, 0.0]],
     [np.sqrt(2.0), 1.0801234, 0.8944272, 0.8660254]),
    ([[1.0, 0.0, 0.0, 1.0], [1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 2.0]],
     [[1.0, 2.0, 0.0, 2.0], [1.0, 2.0, 0.0, 0.0], [2.0, 0.0, 1.0, 2.0]],
     [1.0 / np.sqrt(2.0), 0.74535599, 1.0, 1.5]),
])
def test_live_rhat_golden_values(data0, data1, expected):
    rows = np.asarray([data0, data1], np.float32)
    t, jt = _fold_both(rows)
    np.testing.assert_allclose(stats.tracker_rhat(t).numpy(), expected,
                               atol=1e-5)
    _assert_trackers_close(t, jt, 1e-6)


def test_tracker_moments_match_batch_and_jax():
    rows = np.random.default_rng(7).standard_normal((20, 3, 2)).astype(
        np.float32)
    t, jt = _fold_both(rows)
    cs = stats.tracker_stats(t)
    np.testing.assert_allclose(cs.mean.numpy(), rows.mean(axis=0),
                               atol=1e-5)
    np.testing.assert_allclose(cs.sm2.numpy(), rows.var(axis=0, ddof=1),
                               rtol=1e-4, atol=1e-5)
    _assert_trackers_close(t, jt, 1e-6)


@pytest.mark.parametrize("n,rtol", [(64, 1e-6), (1000, 1e-5)])
def test_tracker_update_matches_jax(n, rtol):
    t, jt = _fold_both(_rows(n, 16, 3, seed=n))
    _assert_trackers_close(t, jt, rtol)


def test_tracker_p_accept_ewma():
    # all-change steps push p_accept toward 1, alpha = 0.01 a chain row
    # (stats.rs:13, :250-255)
    t = stats.tracker_init(2, 1, **CPU)
    x = torch.zeros((2, 1))
    expected = 0.0
    for _ in range(50):
        x = x + 1.0
        t = stats.tracker_update(t, x)
        for _ in range(2):
            expected = (1 - stats.ALPHA) * expected + stats.ALPHA * 1.0
    assert math.isclose(float(t.p_accept), expected, abs_tol=1e-6)


def test_p_accept_decay_underflows_as_in_jax():
    # C = 65,536: (1 - alpha)^C is 0 in float32, so one step leaves only
    # the last ~10,000 chains' weights (both packages)
    c = 65536
    prev = np.zeros((c, 1), np.float32)
    moved = np.ones((c, 1), np.float32)
    t = stats.tracker_update(
        stats.tracker_update(stats.tracker_init(c, 1, **CPU),
                             torch.from_numpy(prev)), torch.from_numpy(moved))
    jt = jstats.tracker_update(jstats.tracker_update(
        jstats.tracker_init(c, 1), jnp.asarray(prev)), jnp.asarray(moved))
    _close(t.p_accept, jt.p_accept, 1e-6)
    assert float(stats._decay(c, torch.device("cpu"))[0]) == 0.0


def test_first_step_compares_coordinate_0_only():
    # ChainTracker's seed (stats.rs:110-116): a chain whose first row
    # differs from last_state in coordinate 1 alone seeds 0
    init = np.zeros((2, 2), np.float32)
    row = np.asarray([[0.0, 5.0], [5.0, 0.0]], np.float32)
    t = stats.tracker_update(stats.tracker_init(2, 2, torch.from_numpy(init)),
                             torch.from_numpy(row))
    jt = jstats.tracker_update(jstats.tracker_init(2, 2, init),
                               jnp.asarray(row))
    a = stats.ALPHA
    np.testing.assert_allclose(t.p_accept_chains.numpy(), [a, 1.0],
                               rtol=1e-6)
    _close(t.p_accept_chains, jt.p_accept_chains, 1e-6)


@pytest.mark.parametrize("case", ["fresh", "repeats", "one_row", "dim1"])
def test_tracker_update_rows_matches_k_updates(case):
    c, p, k = 24, 3, 8
    rows = _rows(3 * k, c, p, seed=11, stay=0.6)
    t = stats.tracker_init(c, p, **CPU)
    if case != "fresh":  # a tracker that has seen a block already
        for i in range(k):
            t = stats.tracker_update(t, torch.from_numpy(rows[i]))
    block = rows[k:2 * k] if case != "fresh" else rows[:k]
    if case == "repeats":  # whole rows repeat: every chain rejected
        block[3] = block[2]
        block[4] = block[3]
    if case == "one_row":
        block = block[:1]
    if case == "dim1":  # [K, C] rows of a one-parameter target
        t = stats.tracker_init(c, 1, **CPU)
        block = block[..., 0]
    want = t
    for row in block:
        want = stats.tracker_update(want, torch.from_numpy(row))
    got = stats.tracker_update_rows(t, torch.from_numpy(block))
    assert got.n == want.n
    for f in ("last_state", "mean", "mean_sq", "p_accept_chains"):
        _close(getattr(got, f), getattr(want, f), 1e-5)
    _close(got.p_accept, want.p_accept, 1e-5, atol=1e-6)
    _close(stats.tracker_rhat(got), stats.tracker_rhat(want), 1e-5)


def test_chain_tracker_matches_jax():
    rows = _rows(30, 1, 3, seed=5)[:, 0]
    t = stats.ChainTracker(3, [0.0, 0.0, 0.0], **CPU)
    jt = jstats.ChainTracker(3, [0.0, 0.0, 0.0])
    for r in rows:
        t.step(r.tolist())
        jt.step(r)
    got, want = t.stats(), jt.stats()
    assert got.n == int(want.n)
    for f in ("p_accept", "mean", "sm2"):
        _close(getattr(got, f), getattr(want, f), 1e-6)


def test_collect_rhat_matches_jax():
    g = np.random.default_rng(3)
    means = g.standard_normal((6, 4)).astype(np.float32) * 0.2
    sm2s = (1.0 + 0.1 * g.random((6, 4))).astype(np.float32)
    ns = np.full(6, 100, np.int32)
    got = stats.collect_rhat(torch.from_numpy(means), torch.from_numpy(sm2s),
                             torch.from_numpy(ns))
    want = jstats.collect_rhat(jnp.asarray(means), jnp.asarray(sm2s),
                               jnp.asarray(ns))
    assert got.shape == (4,) and bool(torch.isfinite(got).all())
    _close(got, want, 1e-6)


@pytest.mark.parametrize("data", [
    [1.0, 2.0, 3.0, 4.0],
    [2.5],
    "random3",
    "random10",
    [3.0, float("nan"), 1.0, 2.0],
])
def test_basic_stats_matches_jax(data):
    if isinstance(data, str):
        n = int(data[len("random"):])
        data = (np.random.default_rng(n).random(n) * 1e3).astype(
            np.float32).tolist()
    got = stats.basic_stats("x", torch.tensor(data))
    want = jstats.basic_stats("x", jnp.asarray(data, jnp.float32))
    for f in ("min", "median", "max"):
        a, b = getattr(got, f), getattr(want, f)
        assert a == b or (math.isnan(a) and math.isnan(b)), (f, a, b)
    for f in ("mean", "std"):
        _close(getattr(got, f), getattr(want, f), 1e-6)
    assert str(got) == str(want)


def test_basic_stats_median_convention():
    # descending sort, element n // 2 (stats.rs:310-336)
    bs = stats.basic_stats("x", torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert (bs.min, bs.median, bs.max) == (1.0, 2.0, 4.0)
    # a NaN compares equal to everything and is not reported as the max
    bs = stats.basic_stats("ESS", [3.0, float("nan"), 1.0, 2.0])
    assert (bs.max, bs.min) == (3.0, 1.0)


def _ar1(c, n, p, seed):
    g = np.random.default_rng(seed)
    x = np.zeros((c, n, p))
    e = g.standard_normal((c, n, p))
    x[:, 0] = e[:, 0]
    for t in range(1, n):
        x[:, t] = 0.6 * x[:, t - 1] + e[:, t]
    return (x + 0.3 * g.standard_normal((c, 1, p))).astype(np.float32)


@pytest.mark.parametrize("n,time_major", [(80, False), (300, True)])
def test_run_stats_matches_jax(n, time_major):
    cube = _ar1(8, n, 3, seed=n)
    if time_major:
        cube = np.ascontiguousarray(cube.transpose(1, 0, 2))
    got = stats.run_stats(torch.from_numpy(cube), time_major=time_major)
    want = jstats.run_stats(jnp.asarray(cube), time_major=time_major)
    for part, rtol in (("ess", ESS_RTOL), ("rhat", RHAT_RTOL)):
        g, w = getattr(got, part), getattr(want, part)
        assert g.name == w.name
        for f in ("min", "median", "max", "mean", "std"):
            _close(getattr(g, f), getattr(w, f), rtol, atol=rtol)
    text = str(got)
    assert "ESS" in text and "Split R-hat" in text


def test_ess_from_chainstats_matches_jax():
    cube = _ar1(4, 80, 3, seed=7)
    means = cube.mean(axis=1)
    sm2s = cube.var(axis=1, ddof=1)
    ns = np.full(4, 80, np.float32)
    got = stats.ess_from_chainstats(torch.from_numpy(cube),
                                    torch.from_numpy(means),
                                    torch.from_numpy(sm2s),
                                    torch.from_numpy(ns))
    want = jstats.ess_from_chainstats(cube, means, sm2s, ns)
    _close(got, want, ESS_RTOL)
