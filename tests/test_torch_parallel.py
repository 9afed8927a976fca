"""Chain and data parallelism of the port over gloo groups on the CPU: the
twins of ``tests/test_parallel.py``'s chain and data tests.

Three spawned groups of two ranks (the chain cases, the data mesh, the
mesh examples) and one of four run every case of ``torch_parallel_cases.py``
once per module; each test reads its case.
Where the JAX tests hold sharded runs to unsharded ones statistically (XLA
may fuse a partitioned program differently), the port holds them bit for
bit: its draws are keyed by global chain. The JAX tests' HLO pins become
counts of ``parallel.collectives``' calls during ``run()``. ChEES's warmup
is held to the JAX bounds only: its batched Gaussian gradient is a matrix
product whose CPU rounding depends on the rows in the batch.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_parallel_cases as cases
from mini_mcmc_tpu import stats as jstats

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return torch_dist.run_ranks(cases.two_ranks, 2,
                                tmp_path_factory.mktemp("two_ranks"),
                                timeout=240)


@pytest.fixture(scope="module")
def two_data(tmp_path_factory):
    return torch_dist.run_ranks(cases.two_ranks_data, 2,
                                tmp_path_factory.mktemp("two_ranks_data"),
                                timeout=240)


@pytest.fixture(scope="module")
def two_examples(tmp_path_factory):
    return torch_dist.run_ranks(cases.two_ranks_examples, 2,
                                tmp_path_factory.mktemp("two_examples"),
                                timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return torch_dist.run_ranks(cases.four_ranks, 4,
                                tmp_path_factory.mktemp("four_ranks"),
                                timeout=180)


def _case(ranks, name) -> list:
    """The case's result on every rank; a rank's error fails the test."""
    out = []
    for rank, res in enumerate(ranks):
        status, value = res[name]
        assert status == "ok", f"rank {rank}:\n{value}"
        out.append(value)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_layout(world, two, four):
    for res in _case(two if world == 2 else four, "layout"):
        assert res["mesh_size"] == world
        assert res["global_shape"] == (32, 4)
        assert res["local"] == (32 // world, 4)
        assert res["rows_equal"] and res["placements"]
        # the cube keeps its chain axis sharded: axis 0, axis 1 time-major
        assert res["cube_shape"] == (16, 10, 3)
        assert res["cube_placement"] == "S(0)"
        assert res["tm_placement"] == "S(1)"
        assert res["n_chains"] == 16


EXACT = [("hmc", t) for t in ("plain", "true", "full", "jitter")] + [
    ("mh", t) for t in ("plain", "full", "poisson")] + [
    ("nuts", t) for t in ("plain", "true", "full")] + [
    ("tempering", t) for t in ("plain", "full")] + [
    ("sgld", t) for t in ("shared", "per_chain", "sghmc")] + [
    ("slice_elliptical", "slice"), ("slice_elliptical", "elliptical")]


@pytest.mark.parametrize("case, tier", EXACT,
                         ids=[f"{c}-{t}" for c, t in EXACT])
def test_sharded_equals_unsharded(case, tier, two):
    for res in _case(two, case):
        assert res[tier]["equal"]
        if case == "hmc":
            assert res[tier]["equal_tm"]
        if case == "nuts":
            assert res[tier]["eps_equal"] and res[tier]["leapfrogs_equal"]


FOUR = [("hmc", "full"), ("hmc", "plain"), ("nuts", "true"),
        ("slice_elliptical", "slice")]


@pytest.mark.parametrize("case, tier", FOUR,
                         ids=[f"{c}-{t}" for c, t in FOUR])
def test_sharded_equals_unsharded_four_ranks(case, tier, four):
    for res in _case(four, case):
        assert res[tier]["equal"]


ZERO = [("hmc", t) for t in ("plain", "true", "full", "jitter")] + [
    ("mh", "plain"), ("mh", "full"), ("tempering", "plain"),
    ("tempering", "full"), ("sgld", "shared"), ("sgld", "per_chain"),
    ("sgld", "sghmc")]


@pytest.mark.parametrize("case, tier", ZERO,
                         ids=[f"{c}-{t}" for c, t in ZERO])
def test_run_makes_no_collective(case, tier, two):
    """The sampling loop never communicates (``test_sampling_scan_
    compiles_to_zero_collectives``)."""
    for res in _case(two, case):
        assert res[tier]["collectives"] == 0


def test_nuts_full_no_collective_lockstep_scalar_only(two):
    for res in _case(two, "nuts"):
        assert res["full"]["all_reduce"] == 0 and res["full"]["heavy"] == 0
        for tier in ("plain", "true"):
            # the loops' exits and the deepest chain: scalars only
            assert res[tier]["heavy"] == 0
            assert res[tier]["all_reduce"] == res[tier]["scalar"] > 0


@pytest.mark.parametrize("sampler", ["slice", "elliptical"])
def test_slice_and_elliptical_scalar_reduce_only(sampler, two):
    for res in _case(two, "slice_elliptical"):
        r = res[sampler]
        assert r["heavy"] == 0
        assert r["all_reduce"] == r["scalar"] > 0


def test_chees_warmup_matches_unsharded(two):
    for res in _case(two, "chees"):
        (sa, sb), (ta, tb) = res["step"], res["traj"]
        assert abs(sa - sb) <= 0.05 * sa
        assert abs(ta - tb) <= 0.05 * ta
        np.testing.assert_allclose(*res["mean"], atol=0.15)
        np.testing.assert_allclose(*res["std"], atol=0.25)
        # the warmup's cross-chain means cross ranks; production does not
        assert res["warm_collectives"] > 0
        assert res["collectives"] == 0


@pytest.mark.parametrize("sampler", ["hmc", "mh", "warmed_up"])
def test_tuned_same_step_size_sharded(sampler, two):
    for res in _case(two, "tuned"):
        r = res[sampler]
        assert r["size"][0] == r["size"][1]
        assert r["equal"]
        if sampler == "warmed_up":
            assert r["metric"]  # estimated from every shard's chains
        else:
            assert r["sharded"] == "DTensor"


def test_ensemble_whole_ensembles_and_guard(two):
    for res in _case(two, "ensemble"):
        assert res["equal"] and res["collectives"] == 0
        assert res["guard"] and "whole ensembles" in res["guard"]


def test_ais_anneal_no_collective(two):
    import mini_mcmc_torch as mt
    from mini_mcmc_torch.models.base import Target

    for res in _case(two, "ais"):
        assert res["anneal_collectives"] == 0
        assert res["weights_equal"] and res["x_equal"]
        # log-Z and the weight ESS gather every shard's weights
        assert res["log_z"][0] == res["log_z"][1]
        assert res["ess"][0] == res["ess"][1]
    target = Target(
        logp=lambda x: -0.5 * torch.sum(x * x),
        logp_batch=lambda xs: -0.5 * torch.sum(xs * xs, dim=-1))
    r = mt.ais_log_z(target, 2048, 2, betas=16, seed=0, device="cpu")
    assert abs(float(r.log_z) - math.log(2 * math.pi)) < 0.1


def test_tempering_state_axes(two):
    for res in _case(two, "tempering"):
        for tier in ("plain", "full"):
            assert res[tier]["spec"] == dict(
                positions="S(2)", raw_logp="S(1)", swap_accept="S(1)",
                parity="int")
            assert res[tier]["swap"]


RHAT_RTOL, ESS_RTOL = 1e-5, 1e-3  # test_torch_stats.py's, against JAX


def test_sharded_diagnostics_match_unsharded_and_jax(two):
    for res in _case(two, "diagnostics"):
        r0, r_tm, r_cm = res["rhat"]
        e0, e_tm, e_cm = res["ess"]
        for r, e in ((r_tm, e_tm), (r_cm, e_cm)):
            np.testing.assert_allclose(r, r0, rtol=RHAT_RTOL)
            np.testing.assert_allclose(e, e0, rtol=ESS_RTOL)
        want_r, want_e = jstats.split_rhat_mean_ess(
            jnp.asarray(res["cube"], jnp.float32), time_major=True)
        np.testing.assert_allclose(r_tm, np.asarray(want_r), rtol=RHAT_RTOL)
        np.testing.assert_allclose(e_tm, np.asarray(want_e), rtol=ESS_RTOL)
        want = jstats.run_stats(jnp.asarray(res["cube"], jnp.float32),
                                time_major=True)
        rh, rh0, es, es0 = res["run_stats"]
        assert rh == pytest.approx(rh0, rel=RHAT_RTOL)
        assert es == pytest.approx(es0, rel=ESS_RTOL)
        assert rh == pytest.approx(float(want.rhat.mean), rel=RHAT_RTOL)
        assert es == pytest.approx(float(want.ess.mean), rel=ESS_RTOL)
        mean, mean0, bulk, bulk0 = res["summary"]
        np.testing.assert_array_equal(mean, mean0)
        np.testing.assert_array_equal(bulk, bulk0)


def test_run_progress_and_stream_run_sharded(two):
    for res in _case(two, "progress_stream"):
        assert res["progress_equal"]
        assert res["rhat"][0] == pytest.approx(res["rhat"][1],
                                               rel=RHAT_RTOL)
        np.testing.assert_allclose(*res["stream_rhat"], rtol=RHAT_RTOL)
        assert res["stream_p"][0] == pytest.approx(res["stream_p"][1],
                                                   abs=1e-6)


def _full_grad():
    """jax.grad of the whole-data log posterior of ``_dpg_problem``."""
    import jax

    _, _, (x, y) = cases._dpg_problem()
    x, y = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def logpost(w):
        r = y - x @ w
        return -0.5 * jnp.sum(w * w) - 0.5 * jnp.sum(r * r)

    return np.asarray(jax.grad(logpost)(jnp.ones(3, jnp.float32)))


def test_data_parallel_grad_unbiased_on_mesh(two_data):
    true = _full_grad()
    for res in _case(two_data, "data_parallel"):
        avg = res["avg"]
        np.testing.assert_allclose(avg[0], avg[1], rtol=1e-6)
        np.testing.assert_allclose(avg[0], true, rtol=0.08)
        ratio = np.mean(avg[0] / true)
        assert 0.9 < ratio < 1.1, f"estimator scale off: ratio={ratio}"


def test_data_parallel_grad_one_all_reduce_per_call(two_data):
    for res in _case(two_data, "data_parallel"):
        c = res["counts_per_call"]
        assert c["all_reduce"] == 1.0
        assert c["all_gather"] == c["broadcast"] == c["barrier"] == 0


def test_data_parallel_grad_deterministic_per_key(two_data):
    for res in _case(two_data, "data_parallel"):
        assert res["deterministic"] and res["differs"]


def test_data_parallel_grad_presharded_validation(two_data):
    for res in _case(two_data, "data_parallel"):
        assert res["pre_equal"]
        for name, err in res["errors"].items():
            assert err is not None, name
            assert "pre-sharded" in err and "Shard(dim=0)" in err


def test_data_parallel_grad_shape_guards(two_data):
    for res in _case(two_data, "data_parallel"):
        assert "divide" in res["guards"]["rows"]
        assert "batch_size" in res["guards"]["batch"]


def test_sgld_with_data_parallel_grad_end_to_end(two_data):
    for res in _case(two_data, "sgld_data_parallel"):
        sd = np.sqrt(res["post_var"])
        assert np.all(np.abs(res["mean"] - res["post_mean"]) < 1.2 * sd)
        assert np.all(np.abs(res["var"] / res["post_var"] - 1.0) < 0.5)
        # one gradient all-reduce a step, nothing heavier
        c = res["counts"]
        assert c["all_reduce"] == 3000 and c["all_gather"] == 0


@pytest.mark.parametrize("guard, word", [("chainless", "chains"),
                                         ("state_dim", "state"),
                                         ("indivisible", "divide")])
def test_guards(guard, word, two):
    for res in _case(two, "guards"):
        assert res[guard] is not None and word in res[guard]


def test_sharded_checkpoint_restores_bit_exactly(two):
    for res in _case(two, "checkpoint"):
        assert res["file_equal"] and res["continues"]
        assert res["sharded"] == "DTensor"


@pytest.mark.parametrize("name, line", [
    ("poisson_mh", "65536 chains x 200 draws over 2 device(s)"),
    ("sharded_chains", "1024 chains sharded over 2 device(s)"),
    ("sgld_data_parallel", "data mesh: 2 device(s), 8192 rows")])
def test_mesh_examples_on_two_ranks(name, line, two_examples):
    for out in _case(two_examples, "examples"):
        assert line in out[name]
