"""``run_progress`` (progress.py), the tracker-threaded runners and
``stream_run`` (stream.py) of mini_mcmc_torch on the CPU.

The cases of tests/test_progress.py (the display, its rotation, the NUTS
conventions, the block runner with a sub-K tail) and of
tests/test_stream.py (its Parquet ones through ``io.ParquetStreamWriter``,
skipped without ``pyarrow``), each on the port's samplers; their statistical bounds are kept. Beside
them, what keying draws by place makes exact: on every sampler's fused
tier through its plain twin (K = 4, small C), a K-aligned
``run_progress`` and ``stream_run``'s chunks give the cube ``run()`` gives
from the same seed, bit for bit, in both layouts and under a metric; the
block runner's tracker equals the one-step runner's (rtol 1e-5, atol 1e-6:
a closed form over a block against K sequential updates); a tempering run
whose length is not a multiple of K records the cold rung in its tail.
"""

import io
import math

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch import stats
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.progress import _MAX_CHAIN_BARS, _ProgressDisplay

torch.set_num_threads(1)

CPU = dict(device="cpu")
NUTS_MEAN, NUTS_COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
LW_MINUS, LW_PLUS = math.log(0.3), math.log(0.7)


def _quiet():
    return io.StringIO()


def _mh(seed=1, n_chains=8, **kw):
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    return mt.MetropolisHastings(target, mt.isotropic_gaussian_proposal(1.0),
                                 mt.init_det(n_chains, 2, **CPU), **CPU,
                                 **kw).seed(seed)


def _nuts(n_chains=8, seed=3, **kw):
    target = mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV)
    return mt.NUTS(target, mt.init_det(n_chains, 2, **CPU), 0.8, **CPU,
                   **kw).seed(seed)


def _mixture() -> Target:
    """0.3 N(-8, 0.5^2) + 0.7 N(8, 0.5^2), naming the CUDA functor."""

    def logp(x):
        a = LW_MINUS - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = LW_PLUS - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                  cuda_params=(LW_MINUS, -8.0, 0.5, LW_PLUS, 8.0, 0.5))


# -- the display and the cases of tests/test_progress.py ---------------------


def test_run_progress_renders_per_chain_bars():
    out = io.StringIO()
    sample, rs = _mh().run_progress(60, 20, stream=out)
    text = out.getvalue()
    assert sample.shape == (8, 60, 2)
    assert isinstance(rs, stats.RunStats)
    assert "Global" in text and "max(rhat)≈" in text
    for idx in range(_MAX_CHAIN_BARS):  # per-chain bars (core.rs:275-276)
        assert f"Chain {idx}" in text, text[-500:]
    assert text.count("p(accept)≈") >= _MAX_CHAIN_BARS + 1
    # the final stats tick rotates one slot: a sixth chain appears
    assert "Chain 5" in text


def test_display_rotation_walks_all_chains_then_stops():
    disp = _ProgressDisplay(7, 100, io.StringIO())
    assert disp.active == [0, 1, 2, 3, 4]
    disp.rotate()
    assert disp.active == [1, 2, 3, 4, 5]
    disp.rotate()
    assert disp.active == [2, 3, 4, 5, 6]
    disp.rotate()  # every chain shown once: rotation stops (core.rs:308)
    assert disp.active == [2, 3, 4, 5, 6]


def test_display_fewer_chains_than_bars():
    disp = _ProgressDisplay(3, 100, io.StringIO())
    assert disp.active == [0, 1, 2]
    disp.rotate()
    assert disp.active == [0, 1, 2]
    disp.render(50, 0.5, torch.full((3,), 0.5), 1.0, 1.0)


def test_nuts_run_progress_no_discard_records_initial_row():
    nuts = _nuts()
    before = nuts.positions.clone()
    out = io.StringIO()
    sample, _ = nuts.run_progress(20, 0, stream=out)
    assert sample.shape == (8, 20, 2)
    assert torch.equal(sample[:, 0], before)
    assert not torch.allclose(sample[:, 1], before)
    assert "Chain 0" in out.getvalue()


def test_nuts_run_progress_single_collect():
    nuts = _nuts()
    before = nuts.positions.clone()
    sample, _ = nuts.run_progress(1, 0, stream=_quiet())
    assert sample.shape == (8, 1, 2)
    assert torch.equal(sample[:, 0], before)


def test_nuts_run_progress_with_discard_matches_run_convention():
    # n_collect + n_discard - 1 steps, as run(): from one seed the cubes
    # are equal, and both agree with the target's moments
    sample_p, _ = _nuts(n_chains=16, seed=0).run_progress(400, 100,
                                                           stream=_quiet())
    assert sample_p.shape == (16, 400, 2)
    assert torch.equal(sample_p, _nuts(n_chains=16, seed=0).run(400, 100))
    sample_r = _nuts(n_chains=16, seed=1).run(400, 100)
    a = sample_p.reshape(-1, 2).double()
    b = sample_r.reshape(-1, 2).double()
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=0.25)
    np.testing.assert_allclose(a.var(0), b.var(0), atol=0.6)
    np.testing.assert_allclose(a.mean(0), NUTS_MEAN, atol=0.3)
    np.testing.assert_allclose(a.var(0), [4.0, 3.0], atol=0.8)


def test_run_progress_time_major_matches_chain_major():
    a, _ = _mh(seed=5).run_progress(30, 10, stream=_quiet())
    b, _ = _mh(seed=5).run_progress(30, 10, stream=_quiet(),
                                    time_major=True)
    assert a.shape == (8, 30, 2) and b.shape == (30, 8, 2)
    assert torch.equal(a, b.transpose(0, 1))


def test_run_progress_drives_block_runner_with_tail():
    # the K-aligned bulk through the block runner, the sub-K rest through
    # the one-step runner; totals that are not multiples of K still work
    mh = _mh(seed=2, steps_per_call=4)
    calls = []
    block_runner, tail_runner = mh._runner, mh._simple_runner
    assert block_runner is not tail_runner

    def spy(kind, runner):
        def run(state, key, c, d, **kw):
            calls.append((kind, c + d))
            return runner(state, key, c, d, **kw)
        return run

    mh._runner = spy("block", block_runner)
    mh._simple_runner = spy("tail", tail_runner)
    sample, _ = mh.run_progress(25, 10, stream=_quiet())
    assert sample.shape == (8, 25, 2)
    assert {k for k, _ in calls} == {"block", "tail"}, calls
    assert all(c % 4 == 0 for k, c in calls if k == "block"), calls
    assert sum(c for _, c in calls) == 35, calls
    assert sum(c for k, c in calls if k == "tail") == 35 % 4, calls


def test_run_progress_block_statistics_match_per_step():
    a, _ = _mh(7, n_chains=64).run_progress(400, 100, stream=_quiet())
    b, _ = _mh(8, n_chains=64, steps_per_call=8).run_progress(
        400, 100, stream=_quiet())
    fa, fb = (s.reshape(-1, 2).double() for s in (a, b))
    np.testing.assert_allclose(fa.mean(0), fb.mean(0), atol=0.2)
    np.testing.assert_allclose(fa.var(0), fb.var(0), atol=0.5)


def test_nuts_run_progress_time_major():
    nuts = _nuts()
    before = nuts.positions.clone()
    sample, _ = nuts.run_progress(20, 0, stream=_quiet(), time_major=True)
    assert sample.shape == (20, 8, 2)
    assert torch.equal(sample[0], before)
    assert not torch.allclose(sample[1], before)


# -- every sampler's fused tier: run_progress gives run()'s cube ------------


def _samplers():
    init2 = lambda c, s: mt.init_with_seed(c, 2, seed=s, **CPU)  # noqa: E731
    dense = mt.Preconditioner("dense", chol=torch.linalg.cholesky(
        torch.tensor([[2.0, 0.3], [0.3, 0.5]])))
    diag = mt.Preconditioner("diag", scale=torch.tensor([2.0, 1.5]))
    return {
        "hmc_full": lambda s: mt.HMC(
            mt.rosenbrock_nd(), init2(16, 1) * 0.3 + 1.0, 0.02, 8,
            use_pallas="full", jitter=0.3, steps_per_call=4, **CPU).seed(s),
        "hmc_true": lambda s: mt.HMC(
            mt.rosenbrock_nd(), init2(16, 1) * 0.3 + 1.0, 0.02, 8,
            use_pallas=True, steps_per_call=4, **CPU).seed(s),
        "hmc_full_metric": lambda s: mt.HMC(
            mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV), init2(16, 2), 0.3,
            4, use_pallas="full", steps_per_call=4, metric=dense,
            **CPU).seed(s),
        "mala_full": lambda s: mt.MALA(
            mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV), init2(16, 3), 0.8,
            use_pallas="full", steps_per_call=4, **CPU).seed(s),
        "separable": lambda s: mt.HMC(
            mt.standard_normal(), mt.init_with_seed(8, 64, seed=4, **CPU),
            0.1, 5, use_pallas="separable", **CPU).seed(s),
        "mh_full": lambda s: _mh(s, n_chains=16, use_pallas="full",
                                 steps_per_call=4),
        "gibbs_full": lambda s: mt.GibbsSampler(
            mt.gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
            torch.zeros((16, 2)), use_pallas="full", steps_per_call=4,
            **CPU).seed(s),
        "pt_full": lambda s: mt.ParallelTempering(
            _mixture(), torch.full((16, 1), -8.0), betas=(1.0, 0.3, 0.1),
            steps_per_call=4, use_pallas="full", **CPU).seed(s),
        "nuts_full": lambda s: _nuts(16, s, use_pallas="full"),
        "nuts_full_metric": lambda s: _nuts(16, s, use_pallas="full",
                                            metric=diag),
    }


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("name", list(_samplers()))
def test_run_progress_equals_run(name, time_major):
    make = _samplers()[name]
    sample, rs = make(11).run_progress(16, 8, stream=_quiet(),
                                       time_major=time_major)
    assert torch.equal(sample, make(11).run(16, 8, time_major=time_major))
    assert isinstance(rs, stats.RunStats)
    assert rs.rhat.name == "Split R-hat"


def test_run_progress_straddling_burn_in_end():
    # n_discard = 10 ends inside a K = 4 block: that block goes through a
    # scratch and its kept rows to the cube; draws keyed by place make it
    # the one-step fused run's cube
    for time_major in (False, True):
        got, _ = _mh(3, use_pallas="full", steps_per_call=4).run_progress(
            25, 10, stream=_quiet(), time_major=time_major)
        want = _mh(3, use_pallas="full").run(25, 10, time_major=time_major)
        assert torch.equal(got, want)


def test_tempering_tail_records_the_cold_rung():
    # 27 + 6 = 33 steps at K = 4: 32 through Kernel 8's twin, one through
    # the one-step runner, which must record the cold rung [C, D] (not the
    # [T, D, C] replica batch)
    make = _samplers()["pt_full"]
    pt = make(5)
    sample, _ = pt.run_progress(27, 6, stream=_quiet())
    assert sample.shape == (16, 27, 1)
    assert torch.equal(sample[:, -1], pt.positions)
    k1 = mt.ParallelTempering(_mixture(), torch.full((16, 1), -8.0),
                              betas=(1.0, 0.3, 0.1), use_pallas="full",
                              **CPU).seed(5)
    assert torch.equal(sample, k1.run(27, 6))


@pytest.mark.parametrize("name", ["hmc_full", "hmc_full_metric", "mh_full",
                                  "gibbs_full", "pt_full"])
def test_block_runner_tracker_equals_one_step_runner(name):
    a, b = _samplers()[name](13), _samplers()[name](13)
    key_a, key_b = a._next_key(), b._next_key()
    out = []
    for s, key, runner in ((a, key_a, a._runner), (b, key_b,
                                                   b._simple_runner)):
        tracker = stats.tracker_init(s.n_chains, s.dim, **CPU)
        s.state, cube, tracker = runner(s.state, key, 8, 8, tracker=tracker,
                                        time_major=True)
        out.append((cube, tracker))
    (cube_a, t_a), (cube_b, t_b) = out
    if name != "hmc_full":  # the jitter draws K values at once
        assert torch.equal(cube_a, cube_b)
    assert t_a.n == t_b.n == 16
    for f in ("last_state", "mean", "mean_sq", "p_accept_chains"):
        torch.testing.assert_close(getattr(t_a, f), getattr(t_b, f),
                                   rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t_a.p_accept, t_b.p_accept, rtol=1e-5,
                               atol=1e-6)


def test_runner_tracker_sees_burn_in_in_user_coordinates():
    # under a metric the tracker folds x = L y, burn-in rows included, and
    # a run without a tracker returns none
    s = _samplers()["hmc_full_metric"](3)
    state0, key = s.state, s._next_key()
    tracker = stats.tracker_init(s.n_chains, s.dim, **CPU)
    state, cube, tracker = s._runner(state0, key, 4, 8, tracker=tracker,
                                     time_major=True)
    assert tracker.n == 12
    torch.testing.assert_close(tracker.last_state, cube[-1])
    torch.testing.assert_close(tracker.last_state,
                               s.metric.to_x(state.positions))
    _, _, none = s._runner(state0, key, 4, 8, time_major=True)
    assert none is None


def test_runner_writes_a_callers_cube_in_place():
    s = _mh(4, use_pallas="full", steps_per_call=4)
    cube = torch.full((20, 8, 2), float("nan"))
    s.state, got, _ = s._runner(s.state, s._next_key(), 8, 4,
                                time_major=True, out=cube[4:12])
    assert got.data_ptr() == cube[4:12].data_ptr()
    assert bool(torch.isfinite(cube[4:12]).all())
    assert bool(torch.isnan(cube[:4]).all() and torch.isnan(cube[12:]).all())
    with pytest.raises(ValueError, match="out must be"):
        s._runner(s.state, s._next_key(), 8, 0, out=cube[:4])


# -- stream_run: the cases of tests/test_stream.py ---------------------------


def _stream_mh(seed=3, **kw):
    target = mt.gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    return mt.MetropolisHastings(
        target, mt.isotropic_gaussian_proposal(1.5),
        mt.init_with_seed(8, 2, seed=0, **CPU), **CPU, **kw).seed(seed)


def test_streamed_chunks_equal_one_run():
    chunks = []
    res = mt.stream_run(_stream_mh(), 256, 64,
                        on_chunk=lambda c, s: chunks.append((s, c)),
                        n_discard=32)
    assert [s for s, _ in chunks] == [0, 64, 128, 192]
    full = torch.cat([c for _, c in chunks], dim=0)
    assert torch.equal(full, _stream_mh().run(256, 32, time_major=True))
    assert res.n_collected == 256
    assert res.p_accept.shape == ()  # the global EWMA
    assert 0.0 < float(res.p_accept) < 1.0
    assert bool(torch.isfinite(res.rhat).all())
    assert "streamed 256" in str(res)


def test_streamed_parquet_equals_one_shot_tensor_export(tmp_path):
    # the streamed file equals save_parquet_tensor of the whole cube row
    # for row, and the cube is the one run() gives from the same seed
    pq = pytest.importorskip("pyarrow.parquet")
    from mini_mcmc_torch.io import ParquetStreamWriter, save_parquet_tensor

    chunks = []
    path = str(tmp_path / "stream.parquet")
    with ParquetStreamWriter(path) as w:

        def both(chunk, start):
            w.append(chunk, start)
            chunks.append((start, chunk))

        res = mt.stream_run(_stream_mh(), 256, 64, on_chunk=both,
                            n_discard=32)
    full = torch.cat([c for _, c in chunks], dim=0)
    save_parquet_tensor(full, str(tmp_path / "oneshot.parquet"))
    streamed = pq.read_table(path)
    oneshot = pq.read_table(str(tmp_path / "oneshot.parquet"))
    assert [s for s, _ in chunks] == [0, 64, 128, 192]
    assert streamed.column_names == ["observation", "chain", "dim_0",
                                     "dim_1"]
    assert streamed.equals(oneshot)  # row for row, the indices included
    assert torch.equal(full, _stream_mh().run(256, 32, time_major=True))
    assert res.n_collected == 256 and 0.0 < float(res.p_accept) < 1.0


def test_parquet_writer_rejects_wrong_orientation(tmp_path):
    pytest.importorskip("pyarrow.parquet")
    from mini_mcmc_torch.io import ParquetStreamWriter

    w = ParquetStreamWriter(str(tmp_path / "x.parquet"), n_chains=8)
    with pytest.raises(ValueError, match="TIME-major"):
        w.append(torch.zeros((8, 32, 2)), 0)  # chain-major [C, k, D]
    w.append(torch.zeros((32, 8, 2)), 0)
    # a change of chain count across chunks, without the constructor's
    w2 = ParquetStreamWriter(str(tmp_path / "y.parquet"))
    w2.append(np.zeros((16, 8, 2)), 0)
    with pytest.raises(ValueError, match="TIME-major"):
        w2.append(np.zeros((8, 16, 2)), 16)
    w.close()
    w2.close()


def test_stream_continues_chains_and_moments():
    seen = []
    mt.stream_run(_stream_mh(seed=9), 2048, 256,
                  on_chunk=lambda c, s: seen.append(c), n_discard=512)
    flat = torch.cat(seen, dim=0).reshape(-1, 2).double()
    np.testing.assert_allclose(flat.mean(0), [0.0, 1.0], atol=0.25)
    # the first row of chunk k+1 is one MH step from the last of chunk k:
    # the chains that rejected it carry across the boundary
    carried = float((seen[1][0] == seen[0][-1]).all(dim=-1).double().mean())
    assert 0.05 < carried < 1.0, carried


def test_stream_determinism_same_seed():
    outs = []
    for _ in range(2):
        chunks = []
        mt.stream_run(_stream_mh(seed=11), 128, 32,
                      on_chunk=lambda c, s: chunks.append(c))
        outs.append(torch.cat(chunks, dim=0))
    assert torch.equal(outs[0], outs[1])


def test_stream_alignment_errors():
    mh = _stream_mh()
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        mt.stream_run(mh, 100, 32)
    with pytest.raises(ValueError, match="chunk_size must be"):
        mt.stream_run(mh, 64, 0)
    blocked = _mh(2, n_chains=4, steps_per_call=8)
    with pytest.raises(ValueError, match="block size"):
        mt.stream_run(blocked, 64, 4)


def test_stream_chain_major_layout():
    shapes = []
    mt.stream_run(_stream_mh(), 64, 32,
                  on_chunk=lambda c, s: shapes.append(tuple(c.shape)),
                  time_major=False)
    assert shapes == [(8, 32, 2), (8, 32, 2)]


def test_stream_with_block_kernel():
    for use_pallas in (False, "full"):
        mh = _mh(5, steps_per_call=8, use_pallas=use_pallas)
        seen = []
        res = mt.stream_run(mh, 128, 64, on_chunk=lambda c, s: seen.append(c),
                            n_discard=64)
        assert res.n_collected == 128
        flat = torch.cat(seen, dim=0).reshape(-1, 2).double()
        np.testing.assert_allclose(flat.mean(0), [0.0, 0.0], atol=0.3)
        twin = _mh(5, steps_per_call=8, use_pallas=use_pallas)
        assert torch.equal(torch.cat(seen, dim=0),
                           twin.run(128, 64, time_major=True))


def test_stream_nuts_adapts_and_samples():
    # the prepare pass once, then the one-step runner: no duplicated row
    # at a chunk boundary
    nuts = mt.NUTS(mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV),
                   mt.init_with_seed(8, 2, seed=3, **CPU), **CPU).seed(4)
    seen = []
    res = mt.stream_run(nuts, 512, 128, on_chunk=lambda c, s: seen.append(c),
                        n_discard=128)
    for k in range(1, len(seen)):
        assert not torch.equal(seen[k][0], seen[k - 1][-1])
    flat = torch.cat(seen, dim=0).reshape(-1, 2).double()
    np.testing.assert_allclose(flat.mean(0), NUTS_MEAN, atol=0.4)
    assert res.n_collected == 512
    assert float(nuts.step_size.min()) > 0.0  # adaptation ran


def test_stream_nuts_divergence_accounting():
    nuts = mt.NUTS(mt.diffable_gaussian2d([0.0, 0.0], [[1.0, 0.0],
                                                       [0.0, 1.0]]),
                   mt.init_with_seed(4, 2, seed=5, **CPU), **CPU).seed(6)
    mt.stream_run(nuts, 64, 32, n_discard=32)
    d = nuts.last_run_divergences
    assert d.shape == (4,) and bool((d >= 0).all())
    lf = nuts.last_run_leapfrogs
    assert lf.shape == (4,) and bool((lf > 0).all())
