"""ChEES-HMC, the ensemble sampler, the slice and elliptical slice
samplers and lockstep parallel tempering on a state whose D is split over
a ``"state"`` mesh axis, on gloo groups on the CPU
(``torch_state_mesh_lockstep_cases.py``: one group of eight ranks for the
``chain_state_mesh(2, 4)`` cases, one of four for the ``(1, 4)`` and
``(2, 2)`` ones, one of one for the ``(1, 1)`` mesh).

A run without adaptation equals the unsharded run bit for bit on at least
99% of chains, and a chain that differs first differs at a decision that
went the other way (an accept: one run moved and the other stayed; or,
for the slice, elliptical and tempering samplers, whose both runs move,
a jump): the sums over D are added in another order. ChEES's adaptation
is compared on float64 states within 1e-6, as the other samplers' are
(``test_torch_state_mesh_samplers.py``).

The JAX package's split runs of the same samplers (``chain_state_mesh(2,
4)``, ``shard_state_dim=True``, on conftest's eight CPU devices) pass the
same moment gates here, in the test process; its tempering state keeps D
whole there (its rule splits a leaf's last axis, the chains).
"""

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import torch_dist
import torch_state_mesh_lockstep_cases as cases

torch.set_num_threads(1)

#: the share of chains a split run without adaptation equals bit for bit
SHARE = 0.99
MESHES = ["2x4", "1x4", "2x2"]
RUNS = ["chees", "ensemble", "slice", "elliptical", "elliptical_vec",
        "tempering"]
#: each run's global D (case_runs)
RUN_DIMS = {"chees": 32, "ensemble": 8, "slice": 8, "elliptical": 32,
            "elliptical_vec": 32, "tempering": 32}


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


def _one_decision(results, name, mesh) -> None:
    """Every state shard of a chain shard moved in the same steps."""
    n_chain, n_state = map(int, mesh.split("x"))
    moved = [r[name]["moved"] for r in results]
    for c in range(n_chain):
        row = moved[n_state * c:n_state * (c + 1)]
        assert all(m == row[0] for m in row), (name, c)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", RUNS)
def test_split_runs(name, mesh, eight, four):
    """Each sampler's split run without adaptation (``case_runs``) against
    unsharded: the chains equal bit for bit on at least 99% of chains,
    each differing chain first differing at a flipped decision, every
    state shard of a chain moving in the same steps, the cube split on
    both axes and ``dim`` the global D. The ensemble's stretch takes the
    global D (at its local D the accepts would differ on most chains), the
    slice sweep the global coordinates and widths, the elliptical prior
    and the tempering ladder their slices of [D] tables."""
    results = _on(mesh, "runs", eight, four)
    for res in results:
        r = res[name]
        assert r["share"] >= SHARE, r
        assert r["decided"], r
        assert r["dim"] == RUN_DIMS[name]
        assert r["placements"] == ("S(0)", "S(2)")
    _one_decision(results, name, mesh)


def _collectives(name, r) -> None:
    """The collectives of one split run, against its steps and its
    density evaluations (``calls``): the port's own (``COUNTS``) and every
    collective by kind (``CommDebugMode``: ``allreduce`` the port's,
    ``all_reduce`` DTensor's)."""
    counts, kinds, steps = r["counts"], r["kinds"], r["steps"]
    assert counts["all_gather"] == counts["broadcast"] == 0, counts
    assert counts["barrier"] == 0, counts
    if name == "chees":  # one [3, C] sum a step, the logp a share
        assert counts["all_reduce"] == steps, counts
        assert counts["all_reduce_scalar"] == 0, counts
        assert kinds == {"allreduce": steps}, kinds
    elif name in ("ensemble", "tempering"):  # a logp a half, an inner sweep
        per_step = 2
        assert counts["all_reduce"] == 0, counts
        assert kinds == {"all_reduce": per_step * steps}, kinds
        assert r["calls"] == per_step * steps, r["calls"]
    else:  # one a density evaluation, the chain axis's loop tests
        assert kinds["all_reduce"] == r["calls"], (kinds, r["calls"])
        assert (counts["all_reduce"] == counts["all_reduce_scalar"]
                == r["host_tests"] == kinds["allreduce"]), (counts, kinds)
        assert set(kinds) == {"all_reduce", "allreduce"}, kinds


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", RUNS)
def test_split_collectives(name, mesh, eight, four):
    """The counted collectives of each split run: ChEES-HMC one state-axis
    all-reduce a step on an elementwise-gradient target; the ensemble two
    a sweep and tempering one an inner sweep (two inner sweeps a step),
    DTensor's; slice and elliptical one a density evaluation (slice: a
    sweep costs D x (1 + stepping-out iterations + shrink iterations)),
    besides the chain axis's scalar loop tests; nothing else."""
    for res in _on(mesh, "runs", eight, four):
        _collectives(name, res[name])


def test_elliptical_dense_prior_split(eight):
    """A [D, D] prior factor on the 2 x 4 split: each rank's rows of the
    factor against its chains' whole normals, run(8) within 1e-5 of
    unsharded on at least 99% of chains."""
    for res in _case(eight, "elliptical_dense"):
        assert res["share"] >= SHARE, res


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["warmed", "reconditioned"])
def test_chees_adaptation_split(name, mesh, eight, four):
    """ChEES ``warmed_up(12)`` and ``warmed_up(8).reconditioned("diag")``
    on float64 states: the step size and trajectory length within 1e-6 of
    unsharded and the same on every rank, the metric's slice within 1e-5,
    the new sampler split as the old, its positions and a run after it
    within 1e-6 on every chain."""
    results = _on(mesh, "chees_adapt", eight, four)
    for res in results:
        r = res[name]
        assert r["split"] and r["placements"] == ("S(0)", "S(1)")
        for key in ("eps", "traj_len"):
            a, b = r[key]
            assert b == pytest.approx(a, rel=1e-6), (key, a, b)
        if "metric_err" in r:
            assert r["metric_err"] <= 1e-5
        assert r["positions"]["share"] == 1.0, r["positions"]
        assert r["run"]["share"] == 1.0, r["run"]
    for key in ("eps", "traj_len"):
        assert len({r[name][key][1] for r in results}) == 1, key


@pytest.mark.parametrize("mesh", MESHES)
def test_tempering_retuned_split(mesh, eight, four):
    """``retuned()`` after a split run(20): the same ladder on every rank,
    equal to unsharded's within 1e-6, the new sampler split and its
    run(6) equal to unsharded chain by chain."""
    results = _on(mesh, "pt_retuned", eight, four)
    ladders = {tuple(r["betas"][1]) for r in results}
    assert len(ladders) == 1, ladders
    for r in results:
        want, got = r["betas"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert r["split"]
        assert r["run"]["share"] >= SHARE and r["run"]["decided"], r["run"]


@pytest.mark.parametrize("name", ["chees", "ensemble", "slice",
                                  "elliptical", "tempering"])
def test_one_by_one_mesh_runs_unsplit_code(name, one):
    """A state axis of one rank: the cube equals unsharded bit for bit and
    no sum crosses the axis, DTensor's included."""
    for res in _case(one, "one_rank"):
        r = res[name]
        assert r["equal"] and r["non_scalar"] == 0 and r["dtensor"] == 0, r


REFUSALS = list(cases._refusing_samplers()) + ["chees_reconditioned_dense"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals(name, four):
    """What these samplers still refuse on a split D raises a named
    ValueError: a transform on ChEES-HMC, the ensemble, slice and
    tempering samplers and ChEES-HMC with a dense metric at the assignment
    (naming the samplers that take a split), ``reconditioned("dense")`` of
    a split ChEES-HMC at the call."""
    for res in _case(four, "refusals_2x2"):
        msg = res[name]
        assert msg is not None and not msg.startswith("construct"), msg
        assert "'state' axis" in msg
        if name != "chees_reconditioned_dense":
            assert "ChEESHMC (a diagonal metric allowed)" in msg, msg


# --- both packages at the JAX twins' gates --------------------------------

GATED = list(cases.GATES)


def _gate(name, means, variances) -> None:
    """The JAX test's gates on each coordinate (``cases.GATES``)."""
    g = cases.GATES[name]
    mean = cases.ELL_POST_MEAN if name == "elliptical" else 0.0
    var = cases.ELL_POST_VAR if name == "elliptical" else 1.0
    means, variances = np.asarray(means), np.asarray(variances)
    assert np.all(np.abs(means - mean) < g["mean_atol"]), means
    if "var_rtol" in g:
        np.testing.assert_allclose(variances, var, rtol=g["var_rtol"])
    else:
        np.testing.assert_allclose(variances, var, atol=g["var_atol"])


@pytest.mark.parametrize("name", GATED)
def test_port_split_moments(name, eight):
    """The port's split run on the 2 x 4 mesh at the gate's configuration
    (ChEES-HMC after ``warmed_up``)."""
    for res in _case(eight, "gates"):
        _gate(name, *res[name])


def _jax_sampler(name, x0):
    import jax.numpy as jnp

    from mini_mcmc_tpu import (
        ChEESHMC,
        EllipticalSliceSampler,
        EnsembleSampler,
        ParallelTempering,
        SliceSampler,
    )
    from mini_mcmc_tpu.models import standard_normal
    from mini_mcmc_tpu.models.base import Target

    sn = standard_normal()
    return {
        "chees": lambda: ChEESHMC(sn, x0, cases.CHEES_EPS),
        "ensemble": lambda: EnsembleSampler(
            sn, x0, walkers_per_ensemble=cases.ENSEMBLE_WALKERS),
        "slice": lambda: SliceSampler(sn, x0),
        "elliptical": lambda: EllipticalSliceSampler(
            Target(logp=lambda x: -0.5 * jnp.sum((x - cases.ELL_MEAN)**2)),
            x0, prior_scale=cases.ELL_PRIOR_SCALE),
        "tempering": lambda: ParallelTempering(
            sn, x0, betas=cases.PT_BETAS, proposal_std=cases.PT_STD),
    }[name]().seed(cases.SEED)


def _x0(name) -> np.ndarray:
    g = cases.GATES[name]
    return np.asarray(mt.init_det(g["chains"], g["dim"], device="cpu"))


@pytest.mark.parametrize("name", GATED)
def test_jax_split_moments(name):
    """The JAX package's split run of the same sampler from the same numpy
    init, on ``chain_state_mesh(2, 4)`` with ``shard_state_dim=True``,
    held to the same gates."""
    from mini_mcmc_tpu.parallel import chain_state_mesh, shard_sampler_state

    s = _jax_sampler(name, _x0(name))
    s.state = shard_sampler_state(chain_state_mesh(2, 4), s.state,
                                  shard_state_dim=True)
    if name == "chees":
        s = s.warmed_up(cases.CHEES_GATE_WARMUP)
    y = np.asarray(s.run(*cases.GATES[name]["run"]))
    flat = y.reshape(-1, y.shape[-1]).astype(np.float64)
    _gate(name, flat.mean(0), flat.var(0))


@pytest.mark.parametrize("name", GATED)
def test_split_initial_logp_matches_jax(name, eight):
    """The split state's cached log density (the likelihood's for the
    elliptical sampler, the cold rung's for tempering), whole on every
    rank, against the JAX sampler's on the same init, rtol 1e-6."""
    st = _jax_sampler(name, _x0(name)).state
    want = np.asarray(st.loglik if name == "elliptical"
                      else st.raw_logp[0] if name == "tempering"
                      else st.logp)
    for res in _case(eight, "gates"):
        np.testing.assert_allclose(res[f"{name}_logp"], want, rtol=1e-6)
