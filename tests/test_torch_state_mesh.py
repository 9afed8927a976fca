"""The state dimension split over a ``"state"`` mesh axis
(``parallel.chain_state_mesh``, ``shard_sampler_state(...,
shard_state_dim=True)``) on gloo groups on the CPU: the twins of
``tests/test_parallel.py:701-765``, and the separable tier's split.

One spawned group of eight ranks runs every ``chain_state_mesh(2, 4)``
case of ``torch_state_mesh_cases.py``, one of four ranks the ``(1, 4)`` and
``(2, 2)`` cases, one of one rank the ``(1, 1)`` mesh; each test reads its
case. Where the JAX tests hold the split run to the unsharded one
statistically, the port holds its positions bit for bit (the momenta are
the global draw's block and an elementwise leapfrog needs no other rank)
and its cached energies within float32 rounding of the reordered sums. The
JAX HLO pin becomes counts of ``parallel.collectives`` and of
``CommDebugMode`` during ``run()``.
"""

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import torch_dist
import torch_state_mesh_cases as cases
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.hmc_sep import (
    hmc_separable,
    hmc_separable_plain,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return torch_dist.run_ranks(cases.eight_ranks, 8,
                                tmp_path_factory.mktemp("eight_ranks"),
                                timeout=300)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return torch_dist.run_ranks(cases.four_ranks, 4,
                                tmp_path_factory.mktemp("four_ranks"),
                                timeout=240)


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


def test_initial_state_and_layout(eight):
    """``test_state_dim_sharded_hmc_matches_unsharded``'s first half: the
    split state's logp and gradient are the unsharded ones (rtol 1e-6),
    and the positions lie over all eight ranks, a [32, 128] block each."""
    for res in _case(eight, "layout_moments"):
        init = res["init"]
        assert init["logp"] and init["grad"]
        assert init["placements"] == ("S(0)", "S(1)")
        assert init["global_shape"] == (64, 512)
        assert init["local"] == (32, 128)
        assert init["mesh_size"] == 8
        assert init["dim"] == 512 and init["n_chains"] == 64


def test_initial_state_matches_jax():
    """The port's initial logp and gradient against the JAX package's HMC
    on the same numpy init (rtol 1e-6); the split state holds these
    (``test_initial_state_and_layout``)."""
    from mini_mcmc_tpu import HMC as JHMC
    from mini_mcmc_tpu import init_det as jinit
    from mini_mcmc_tpu.models import standard_normal as jsn

    x0 = np.asarray(jinit(cases.C, cases.D))
    j = JHMC(jsn(), x0, cases.EPS, cases.L).seed(cases.SEED)
    p = mt.HMC(mt.standard_normal(), torch.tensor(x0), cases.EPS,
               cases.L, seed=cases.SEED, device="cpu")
    np.testing.assert_allclose(p.state.logp.numpy(),
                               np.asarray(j.state.logp), rtol=1e-6)
    np.testing.assert_allclose(p.state.grad.numpy(),
                               np.asarray(j.state.grad), rtol=1e-6)


def test_moments_of_both_runs(eight):
    """The JAX twin's gates on ``run(200, 100)``: |mean| < 0.02 and |var
    - 1| < 0.05 for the unsharded and the split run."""
    for res in _case(eight, "layout_moments"):
        m_a, v_a, m_b, v_b = res["moments"]
        assert abs(m_a) < 0.02 and abs(m_b) < 0.02, res["moments"]
        assert abs(v_a - 1.0) < 0.05 and abs(v_b - 1.0) < 0.05


@pytest.mark.parametrize("name", ["hmc", "hmc_jitter", "hmc_table",
                                  "mala", "rosenbrock"])
def test_short_run_equals_unsharded(name, eight):
    """run(20) of the split sampler against the unsharded one: each
    rank's block within 1e-5 (bit for bit here), the cached logp within
    float32 rounding of the reordered sum. The tabled density's plain [D]
    scale is narrowed to the slice (bit for bit). Rosenbrock couples
    neighbouring coordinates, so its DTensor view redistributes."""
    for res in _case(eight, "short_runs"):
        r = res[name]
        assert r["err"] <= 1e-5
        assert r["logp_err"] <= 1e-6 * 512
        if name == "hmc_table":
            assert r["equal"]


def test_every_state_shard_of_a_chain_takes_one_decision(eight):
    """The accept uniforms are drawn per chain from the shared stream, so
    the four state shards of a chain shard move in the same steps."""
    for name in ("hmc", "mala"):
        moved = [r[name]["moved"] for r in _case(eight, "short_runs")]
        for chain_rank in range(2):
            row = moved[4 * chain_rank:4 * chain_rank + 4]
            assert all(m == row[0] for m in row), (name, chain_rank)
        assert not all(all(map(all, m)) for m in moved)  # some rejected


def test_lockstep_run_makes_only_all_reduces(eight):
    """``test_state_dim_sharded_scan_all_reduce_only``'s twin (16 x 1,024,
    run(32, 8)): all-reduces, at least one (the positive control), and
    no all-gather, all-to-all, reduce-scatter or broadcast. The generator
    broadcast at the assignment (one over each axis) is counted apart."""
    for res in _case(eight, "all_reduce_only"):
        assert res["assign"]["broadcast"] == 2
        kinds = res["kinds"]
        assert kinds and set(kinds) <= {"all_reduce", "allreduce"}, kinds
        assert sum(kinds.values()) >= 1
        counts = res["counts"]
        assert counts["all_reduce"] >= 1
        assert counts["all_gather"] == counts["broadcast"] == 0
        assert counts["barrier"] == 0
        # one all-reduce a step for the kinetic energies, one for the logp
        assert counts["all_reduce"] == 40 and kinds["all_reduce"] == 40


SEP = [(m, t) for m in ("1x4", "2x2") for t in ("normal", "table")]


@pytest.mark.parametrize("mesh, target", SEP,
                         ids=[f"{m}-{t}" for m, t in SEP])
def test_separable_split(mesh, target, four):
    """The separable tier at D = 2,048: one step's positions bit for bit,
    the cached logp at rtol 1e-5, exactly one all-reduce a step over four
    steps and no other collective, the four steps' blocks bit for bit."""
    for res in _case(four, f"separable_{mesh}"):
        r = res[target]
        assert r["equal"] and r["logp_close"]
        assert r["counts"]["all_reduce"] == 4
        assert sum(r["counts"].values()) == 4
        assert r["kinds"] == {"allreduce": 4}
        assert r["err4"] == 0.0


@pytest.mark.parametrize("path", ["lockstep", "separable"])
def test_one_by_one_mesh_runs_unsplit_code(path, one):
    """A state axis of one rank: the cube equals the unsharded run's bit
    for bit through the same calls (the separable tier's fused form's
    twin 12 times each), with no collective."""
    for res in _case(one, "one_rank"):
        r = res[path]
        assert r["equal"]
        assert r["placements"] == ("S(0)", "S(2)")
        assert r["calls"][0] == r["calls"][1]
        assert r["calls"][0] == (12 if path == "separable" else 0)
        assert not any(r["counts"].values()) and not r["kinds"]


@pytest.mark.parametrize("what", ["cube_equal", "rhat", "ess", "rank",
                                  "summary"])
def test_diagnostics_of_a_split_cube(what, eight):
    """split R-hat and ESS (time-major and chain-major),
    rank_normalized_diagnostics and summary of a 2 x 4 split cube equal
    those of the same cube whole to 1e-6."""
    for res in _case(eight, "diagnostics"):
        assert res[what]


def test_run_progress_and_stream_trackers(eight):
    """run_progress's cube and RunStats and stream_run's live R-hat and
    acceptance on a split run equal the unsharded ones."""
    for res in _case(eight, "diagnostics"):
        assert res["progress_equal"]
        r_b, r_a, e_b, e_a = res["progress_rhat"]
        assert r_b == pytest.approx(r_a, rel=1e-6)
        assert e_b == pytest.approx(e_a, rel=1e-6)
        ra, rb = res["stream_rhat"]
        np.testing.assert_allclose(rb, ra, rtol=1e-6)
        assert len(rb) == 16
        pa, pb = res["stream_p"]
        assert pb == pytest.approx(pa, rel=1e-6)


def test_checkpoint_of_a_split_run(eight):
    """save_sampler gathers D too: at the assignment the file's tensors
    are the unsharded save's bit for bit; after run(8) the positions and
    gradient are, the logp within rtol 1e-5; a split sampler restored from
    it stays split and continues bit for bit."""
    for res in _case(eight, "checkpoint"):
        assert all(eq for eq, _ in res["assigned"].values())
        after = res["after_run"]
        assert after["positions"][0] and after["grad"][0]
        assert after["logp"][1]
        assert res["restored_split"] and res["continues"]


GUARDS = [("too_few_ranks", "need"), ("indivisible", "divide"),
          ("separable_quads", "multiple of")]


@pytest.mark.parametrize("mesh", ["2x4", "1x4", "2x2"])
@pytest.mark.parametrize("guard, word", GUARDS,
                         ids=[g for g, _ in GUARDS])
def test_guards(guard, word, mesh, eight, four):
    results = (_case(eight, "guards") if mesh == "2x4"
               else _case(four, f"guards_{mesh}"))
    for res in results:
        assert res[guard] is not None and word in res[guard], res[guard]


@pytest.mark.parametrize("mesh", ["2x4", "1x4", "2x2"])
def test_state_axis_index_keeps_a_table_whole(mesh, eight, four):
    """A field that its state type's ``STATE_AXIS_INDEX`` leaves out (a
    ``[C, 3]`` table) stays whole on the state axis; the positions
    split."""
    results = (_case(eight, "guards") if mesh == "2x4"
               else _case(four, f"guards_{mesh}"))
    n_chain, n_state = map(int, mesh.split("x"))
    for res in results:
        pos, table, local = res["tabled"]
        assert pos == ("S(0)", "S(1)") and table == ("S(0)", "R")
        assert local == (16 // n_chain, 8 // n_state)


@pytest.mark.parametrize("mesh", ["2x4", "1x4", "2x2"])
def test_chain_sharding_on_a_state_mesh(mesh, eight, four):
    """``shard_chains`` and ``chain_sharding`` keep their meaning on a 2-D
    mesh: the chains split, the state axis replicated."""
    results = (_case(eight, "guards") if mesh == "2x4"
               else _case(four, f"guards_{mesh}"))
    n_chain = int(mesh.split("x")[0])
    for res in results:
        placements, same, local = res["chains_only"]
        assert placements == ("S(0)", "R") and same
        assert local == (16 // n_chain, 8)


REFUSALS = list(cases._refusing_samplers()) + ["ais"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals(name, four):
    """Every sampler and tier that does not take a split D raises a named
    ValueError at the assignment (no silent gather of D), naming what
    does; make_anneal's anneal on a split x0 at its call."""
    for res in _case(four, "refusals_2x2"):
        msg = res[name]
        assert msg is not None and not msg.startswith("construct"), msg
        assert "'state' axis" in msg
        if name != "ais":
            assert "lockstep HMC, MALA and NUTS (use_pallas=False" in msg


def test_hmc_separable_plain_at_a_d_slice():
    """Kernel 7's twin at d0: each D-slice's positions are the whole
    call's columns bit for bit, its three sums add up to the whole's."""
    c, d, w = 8, 64, 16
    g = torch.Generator().manual_seed(3)
    x = torch.randn((c, d), generator=g)
    s = torch.linspace(0.5, 2.0, d)[None]
    target = cases._scaled_normal(d)
    eps = torch.tensor([0.2])
    whole = hmc_separable(target, x, eps, 5, 0x5EED_23, 4, s, chain0=9)
    parts = [hmc_separable(target, x[:, d0:d0 + w].contiguous(), eps, 5,
                           0x5EED_23, 4, s[:, d0:d0 + w].contiguous(),
                           chain0=9, d0=d0, n_dim=d)
             for d0 in range(0, d, w)]
    assert torch.equal(torch.cat([p[0] for p in parts], dim=1), whole[0])
    for i in (1, 2, 3):
        torch.testing.assert_close(sum(p[i] for p in parts), whole[i],
                                   rtol=1e-5, atol=1e-5)
    # the plain twin is what the wrapper runs on the CPU
    again = hmc_separable_plain(target, x[:, 16:32].contiguous(), eps, 5,
                                0x5EED_23, 4, s[:, 16:32].contiguous(),
                                chain0=9, d0=16)
    assert torch.equal(again[0], parts[1][0])


def test_paired_normals_at_a_d_slice():
    whole = rng.paired_normals(4, 40, 7, 0x1234, chain0=5)
    for d0 in (0, 8, 20, 36):
        part = rng.paired_normals(4, 40 - d0, 7, 0x1234, chain0=5, d0=d0)
        assert torch.equal(part, whole[:, d0:])
    with pytest.raises(ValueError, match="multiple of 4"):
        rng.paired_normals(4, 8, 7, 0x1234, d0=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        hmc_separable(mt.standard_normal(), torch.zeros(2, 8),
                      torch.tensor([0.1]), 2, 1, 0, torch.zeros(0, 8),
                      d0=6)


def test_chain_state_mesh_defaults_to_the_card():
    """Without a GPU the mesh raises unless ``device="cpu"`` is given,
    before any process group starts."""
    import torch.distributed as dist

    from mini_mcmc_torch.parallel import chain_state_mesh

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain_state_mesh(1, 1)
    assert not dist.is_initialized()
