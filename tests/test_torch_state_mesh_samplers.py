"""Lockstep MH, NUTS, SGLD, pSGLD and SGHMC on a state whose D is split
over a ``"state"`` mesh axis, and the adaptation and a diagonal metric on
split HMC, MALA, NUTS and MH, on gloo groups on the CPU
(``torch_state_mesh_sampler_cases.py``: one group of eight ranks for the
``chain_state_mesh(2, 4)`` cases, one of four for the ``(1, 4)`` and
``(2, 2)`` ones, one of one for the ``(1, 1)`` mesh).

A run without adaptation equals the unsharded run bit for bit on at least
99% of chains (the elementwise SG-MCMC runs on every chain), and a chain
that differs first differs at a decision that went the other way: the
energies are summed over the D-slices in another order. Under adaptation
the step size is a continuous function of those sums, and the dual
averaging's first iterations amplify a difference in the mean acceptance
(by about 1e8 over 20 HMC steps here, split or not), so the adaptation is
compared on float64 states: the tuned step size or factor within 1e-5,
the metric's slice within 1e-5, the positions within 1e-6.

The JAX package's split runs of the same samplers (``chain_state_mesh(2,
4)``, ``shard_state_dim=True``, on conftest's eight CPU devices) pass the
same moment gates here, in the test process.
"""

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import torch_dist
import torch_state_mesh_sampler_cases as cases

torch.set_num_threads(1)

#: the share of chains a split run without adaptation equals bit for bit
SHARE = 0.99
MESHES = ["2x4", "1x4", "2x2"]


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return torch_dist.run_ranks(cases.eight_ranks, 8,
                                tmp_path_factory.mktemp("eight_ranks"),
                                timeout=300)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return torch_dist.run_ranks(cases.four_ranks, 4,
                                tmp_path_factory.mktemp("four_ranks"),
                                timeout=300)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return torch_dist.run_ranks(cases.one_rank, 1,
                                tmp_path_factory.mktemp("one_rank"),
                                timeout=120)


def _case(ranks, name) -> list:
    """The case's result on every rank; a rank's error fails the test."""
    out = []
    for rank, res in enumerate(ranks):
        status, value = res[name]
        assert status == "ok", f"rank {rank}:\n{value}"
        out.append(value)
    return out


def _on(mesh, name, eight, four) -> list:
    return (_case(eight, name) if mesh == "2x4"
            else _case(four, f"{name}_{mesh}"))


def _matches(r) -> None:
    assert r["share"] >= SHARE, r
    assert r["decided"], r


def _one_decision(results, name, mesh) -> None:
    """Every state shard of a chain shard moved in the same steps."""
    n_chain, n_state = map(int, mesh.split("x"))
    moved = [r[name]["moved"] for r in results]
    for c in range(n_chain):
        row = moved[n_state * c:n_state * (c + 1)]
        assert all(m == row[0] for m in row), (name, c)


@pytest.mark.parametrize("mesh", MESHES)
def test_mh_split(mesh, eight, four):
    """Lockstep MH, run(24) at 32 x 64: the chains equal unsharded, one
    decision per chain on every shard, and two all-reduces a step (the
    logp's and both q terms'), nothing else."""
    results = _on(mesh, "runs", eight, four)
    for res in results:
        r = res["mh"]
        _matches(r)
        assert r["counts"]["all_reduce"] == 0  # both through DTensor
        assert r["kinds"] == {"all_reduce": 2 * r["steps"]}, r["kinds"]
    _one_decision(results, "mh", mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["mh_scales", "mh_int"])
def test_mh_split_builtin_walks(name, mesh, eight, four):
    """MH on the other built-in random walks, which set
    Proposal.takes_state_split: per-coordinate Gaussian scales and the
    integer walk on a Poisson target, run(24) at 32 x 64, as above."""
    results = _on(mesh, "runs", eight, four)
    for res in results:
        r = res[name]
        _matches(r)
        assert r["counts"]["all_reduce"] == 0
        assert set(r["kinds"]) == {"all_reduce"}, r["kinds"]
        assert r["kinds"]["all_reduce"] <= 2 * r["steps"], r["kinds"]
    _one_decision(results, name, mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_nuts_split(mesh, eight, four):
    """Lockstep NUTS, run(6) at 16 x 32 after its step-size search: the
    chains equal unsharded (the step sizes bit for bit), and the sums over
    D cross the state axis at most twice a target evaluation (one at each
    leaf and at each step's start, one more at each doubling), besides the
    chain axis's scalar loop exits; nothing but all-reduces."""
    results = _on(mesh, "runs", eight, four)
    for res in results:
        r = res["nuts"]
        _matches(r)
        assert r["eps_equal"]
        c = r["counts"]
        state_sums = c["all_reduce"] - c["all_reduce_scalar"]
        assert r["calls"] <= state_sums <= 2 * r["calls"], (r["calls"], c)
        assert c["all_gather"] == c["broadcast"] == c["barrier"] == 0
        assert set(r["kinds"]) <= {"allreduce"}, r["kinds"]
    _one_decision(results, "nuts", mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["sgld", "psgld", "sghmc", "sgld_own"])
def test_sgmcmc_split_elementwise(name, mesh, eight, four):
    """SGLD, pSGLD and SGHMC on an elementwise gradient (target_grad of a
    standard normal; ``sgld_own``: a caller's own gradient that sets
    ``takes_state_split``), run(16): bit for bit, with no collective at
    all (pSGLD's RMS average split too)."""
    for res in _on(mesh, "runs", eight, four):
        r = res[name]
        assert r["equal"]
        assert not any(r["counts"].values()) and not r["kinds"], r
        if name == "psgld":
            assert r["sq_avg_equal"]


@pytest.mark.parametrize("mesh", MESHES)
def test_sgld_split_minibatch_logistic(mesh, eight, four):
    """SGLD on minibatch_grad of a logistic likelihood: 10 steps within
    1e-5 of unsharded; the likelihood's ``X @ p`` all-reduces inside the
    DTensor view, nothing heavier."""
    for res in _on(mesh, "runs", eight, four):
        r = res["sgld_logistic"]
        assert r["err"] <= 1e-5, r
        assert r["kinds"].get("all_reduce", 0) >= 10
        assert set(r["kinds"]) <= {"all_reduce", "allreduce"}, r["kinds"]


@pytest.mark.parametrize("mesh", ["2x4", "2x2"])
@pytest.mark.parametrize("name", ["hmc", "mala", "nuts"])
def test_diag_metric_split(name, mesh, eight, four):
    """``metric=Preconditioner("diag", ...)`` on split HMC, MALA and NUTS:
    the recorded rows, mapped through the metric's slice, equal unsharded
    chain by chain."""
    for res in _on(mesh, "metric", eight, four):
        _matches(res[name])


ADAPT = ["hmc_tuned", "hmc_warmed", "hmc_reconditioned", "mala_warmed",
         "nuts_warmed", "mh_tuned"]


@pytest.mark.parametrize("mesh", ["2x4", "1x4", "2x2"])
@pytest.mark.parametrize("name", ADAPT)
def test_adaptation_split(name, mesh, eight, four):
    """``tuned``, ``reconditioned("diag")`` and ``warmed_up("diag")`` on a
    split sampler against the same calls unsharded, on float64 states
    (the module's docstring says why): the tuned step size or factor
    within 1e-5, the metric's slice within 1e-5 and its ``sigma_min``,
    the new sampler split as the old, its positions and a run after it
    within 1e-6 on every chain."""
    for res in _on(mesh, "adapt", eight, four):
        r = res[name]
        assert r["split"] and r["placements"] == ("S(0)", "S(1)")
        for key in ("eps", "factor"):
            if key in r:
                a, b = r[key]
                assert b == pytest.approx(a, rel=1e-5), (key, a, b)
        if "metric_err" in r:
            assert r["metric_err"] <= 1e-5
            a, b = r["sigma_min"]
            assert b == pytest.approx(a, rel=1e-6)
        assert r["positions"]["share"] == 1.0, r["positions"]
        assert r["run"]["share"] == 1.0, r["run"]


TOOLS = ["mh", "nuts", "sgld", "psgld", "sghmc", "hmc_metric"]


@pytest.mark.parametrize("name", TOOLS)
def test_run_tools_split(name, four):
    """run_progress, stream_run and a checkpoint round-trip of each newly
    split sampler on the 2 x 2 mesh: the progress cube equals unsharded
    chain by chain and its R-hat; the stream's live R-hat and acceptance;
    the checkpoint file is the unsharded one's (the logp within 1e-5),
    restores split and continues bit for bit."""
    for res in _case(four, "tools_2x2"):
        r = res[name]
        _matches(r["progress"])
        a, b = r["progress_rhat"]
        assert b == pytest.approx(a, rel=1e-5)
        ra, rb = r["stream_rhat"]
        np.testing.assert_allclose(rb, ra, rtol=1e-5)
        pa, pb = r["stream_p"]
        assert pb == pytest.approx(pa, rel=1e-6)
        assert all(r["file"].values()), r["file"]
        assert r["restored_split"] and r["continues"]


def test_find_reasonable_epsilon_on_a_split_state(four):
    """The reference input's golden step size, 2.0, on every rank of a
    2 x 2 split (each rank holds one coordinate of two chains)."""
    for eps in _case(four, "find_eps_2x2"):
        assert eps == [2.0, 2.0]


@pytest.mark.parametrize("name", ["mh", "nuts", "sgld", "sghmc"])
def test_one_by_one_mesh_runs_unsplit_code(name, one):
    """A state axis of one rank: the cube equals unsharded bit for bit and
    no sum crosses the axis."""
    for res in _case(one, "one_rank"):
        r = res[name]
        assert r["equal"] and r["non_scalar"] == 0, r


REFUSALS = ["mh_unmarked_proposal", "sgld_unmarked_grad_fn",
            "sghmc_unmarked_grad_fn", "nuts_true", "nuts_full", "mh_full",
            "dense_metric",
            "transform", "data_parallel_grad", "data_parallel_grad_call",
            "reconditioned_dense"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals(name, four):
    """What still takes the whole state raises a named ValueError at the
    assignment (a proposal or a caller's grad_fn that does not set
    takes_state_split, the fused NUTS and MH tiers, a dense metric, a
    transform, data_parallel_grad) or at the call (data_parallel_grad's
    gradient, reconditioned("dense")): never a silent run on a slice or
    gather of D."""
    for res in _case(four, "refusals_2x2"):
        msg = res[name]
        assert msg is not None and not msg.startswith("construct"), msg
        assert "'state' axis" in msg
        if "unmarked" in name:
            assert "does not set takes_state_split" in msg, msg


# --- both packages at the JAX twin's gates --------------------------------

GATED = ["mh", "nuts", "sgld", "sghmc"]


def _gate(mean, var) -> None:
    assert abs(mean) < cases.MEAN_GATE, (mean, var)
    assert abs(var - 1.0) < cases.VAR_GATE, (mean, var)


@pytest.mark.parametrize("name", GATED)
def test_port_split_moments(name, eight):
    """The port's split run(200, 100) at 64 x 16 on the 2 x 4 mesh."""
    for res in _case(eight, "gates"):
        _gate(*res[name])


def _jax_sampler(name, x0):
    from mini_mcmc_tpu import (
        NUTS,
        SGHMC,
        SGLD,
        MetropolisHastings,
        target_grad,
    )
    from mini_mcmc_tpu.models import (
        isotropic_gaussian_proposal,
        standard_normal,
    )

    sn = standard_normal()
    return {
        "mh": lambda: MetropolisHastings(
            sn, isotropic_gaussian_proposal(cases.MH_STD), x0),
        "nuts": lambda: NUTS(sn, x0),
        "sgld": lambda: SGLD(target_grad(sn), x0, cases.SGLD_EPS),
        "sghmc": lambda: SGHMC(target_grad(sn), x0, cases.SGHMC_EPS,
                               friction=cases.SGHMC_FRICTION),
    }[name]().seed(cases.SEED)


@pytest.mark.parametrize("name", GATED)
def test_jax_split_moments(name):
    """The JAX package's split run(200, 100) of the same sampler from the
    same numpy init, on ``chain_state_mesh(2, 4)`` with
    ``shard_state_dim=True``, held to the same gates."""
    from mini_mcmc_tpu.parallel import chain_state_mesh, shard_sampler_state

    x0 = np.asarray(mt.init_det(cases.GATE_C, cases.GATE_D, device="cpu"))
    s = _jax_sampler(name, x0)
    s.state = shard_sampler_state(chain_state_mesh(2, 4), s.state,
                                  shard_state_dim=True)
    y = np.asarray(s.run(*cases.GATE_RUN))
    _gate(float(y.mean()), float(y.var()))


def test_split_initial_logp_matches_jax(eight):
    """The split MH state's logp (summed over the D-slices, whole on every
    rank) against the JAX sampler's on the same init, rtol 1e-6."""
    x0 = np.asarray(mt.init_det(cases.GATE_C, cases.GATE_D, device="cpu"))
    want = np.asarray(_jax_sampler("mh", x0).state.logp)
    for res in _case(eight, "gates"):
        np.testing.assert_allclose(res["mh_logp"], want, rtol=1e-6)
