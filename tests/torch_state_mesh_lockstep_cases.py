"""The rank side of ``test_torch_state_mesh_lockstep.py``: ChEES-HMC, the
ensemble sampler, the slice and elliptical slice samplers and lockstep
parallel tempering on a state whose D is split over a ``"state"`` axis.
Every case runs on each rank of one spawned gloo group
(``torch_dist.run_ranks``) and returns what the parent asserts. Imports
torch and the port only (the children never load JAX).

A case builds the same sampler twice from one seed, splits one's state
(``shard_sampler_state(..., shard_state_dim=True)``) and compares the
rank's block of its cube with the same block of the unsharded cube, which
every rank computes itself (``torch_state_mesh_sampler_cases.
chain_match``). The densities count their calls, so that a case can pin
the collectives of a run against the evaluations it made.
"""

import traceback

import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import Preconditioner
from mini_mcmc_torch.models.base import Target
from mini_mcmc_torch.models.transforms import CoordinateTransform, positive
from mini_mcmc_torch.parallel import chain_state_mesh, shard_sampler_state
from mini_mcmc_torch.ops import slice as slice_ops
from torch_state_mesh_cases import _assign, _block, _comm, _error, _run
from torch_state_mesh_sampler_cases import _split, chain_match, close_match

CPU = dict(device="cpu")
SEED = 7

#: the gates' configurations, each from the JAX package's own moment test
#: of the sampler: (chains, D, run) and the gates on each coordinate's
#: mean and variance (``tests/test_chees.py:60-70``,
#: ``test_ensemble.py:53-69``, ``test_slice.py:89-101``,
#: ``test_elliptical.py:44-59``, ``test_tempering.py:79-87``)
GATES = {
    "chees": dict(chains=64, dim=8, run=(200, 50), mean_atol=0.3,
                  var_rtol=0.25),
    "ensemble": dict(chains=64, dim=4, run=(400, 100), mean_atol=0.15,
                     var_atol=0.15),
    "slice": dict(chains=64, dim=4, run=(100, 50), mean_atol=0.08,
                  var_atol=0.12),
    "elliptical": dict(chains=64, dim=4, run=(200, 100), mean_atol=0.05,
                       var_rtol=0.08),
    "tempering": dict(chains=64, dim=4, run=(600, 200), mean_atol=0.1,
                      var_atol=0.12),
}
#: ChEES's warm-up before its gated run, its first step size
CHEES_GATE_WARMUP, CHEES_EPS = 60, 0.3
ENSEMBLE_WALKERS = 16
#: the elliptical gate's conjugate model: likelihood N(x; m, 1), prior
#: N(0, 2^2): the posterior N(0.8 m, 0.8) on every coordinate
ELL_MEAN, ELL_PRIOR_SCALE = 0.5, 2.0
ELL_POST_MEAN, ELL_POST_VAR = 0.4, 0.8
PT_BETAS, PT_STD = (1.0, 0.5, 0.25), 1.2


def _counting(calls: list) -> Target:
    """A standard normal whose logp counts its calls (one a density
    evaluation) in ``calls[0]``."""
    def logp(x):
        calls[0] += 1
        return -0.5 * torch.sum(x * x, dim=-1)

    return Target(logp=logp)


def _chees(c, d, target=None, dtype=torch.float32, **kw):
    return lambda: mt.ChEESHMC(
        target or mt.standard_normal(), mt.init_det(c, d, **CPU).to(dtype),
        0.2, traj_len=1.0, seed=SEED, **kw, **CPU)


def _ensemble(c, d, w, target=None):
    return lambda: mt.EnsembleSampler(
        target or mt.standard_normal(), mt.init_det(c, d, **CPU),
        walkers_per_ensemble=w, seed=SEED, **CPU)


def _slice(c, d, target=None, width=None):
    return lambda: mt.SliceSampler(
        target or mt.standard_normal(), mt.init_det(c, d, **CPU),
        width=torch.linspace(0.5, 2.0, d) if width is None else width,
        seed=SEED, **CPU)


def _elliptical(c, d, loglik, prior_mean=0.0, prior_scale=1.5):
    return lambda: mt.EllipticalSliceSampler(
        loglik, mt.init_det(c, d, **CPU), prior_mean=prior_mean,
        prior_scale=prior_scale, seed=SEED, **CPU)


def _tempering(c, d, target=None, proposal_std=None, n_inner=2, **kw):
    return lambda: mt.ParallelTempering(
        target or mt.standard_normal(), mt.init_det(c, d, **CPU),
        betas=mt.geometric_betas(4, 0.1),
        proposal_std=(torch.linspace(0.3, 0.6, d) if proposal_std is None
                      else proposal_std),
        n_inner=n_inner, seed=SEED, **kw, **CPU)


def _counted_run(b, calls, run_args):
    """``b.run(*run_args)`` with its collectives (``_comm``), the density
    evaluations it made and the masked loops' host tests."""
    calls[0] = 0
    tests = slice_ops.masked_loop.host_tests
    cube, counts, kinds = _comm(lambda: b.run(*run_args))
    return cube, dict(counts=counts, kinds=kinds, calls=calls[0],
                      host_tests=slice_ops.masked_loop.host_tests - tests,
                      steps=sum(run_args))


def _pair(name, make, calls, run_args, merges=False):
    """One sampler from one seed, unsharded and split on the mesh of the
    caller's :func:`_split`: the rank's block against unsharded chain by
    chain, and the split run's collectives and evaluations."""
    a, b = make()
    x0 = a.positions.clone()
    full = a.run(*run_args)
    cube, res = _counted_run(b, calls, run_args)
    res.update(chain_match(full, cube, x0, merges=merges),
               dim=b.dim, placements=tuple(str(p) for p in cube.placements))
    return res


def case_runs(mesh):
    """Each sampler without adaptation against unsharded: ChEES-HMC
    run(12) at 16 x 32, the ensemble run(16) at 32 x 8 (16 walkers an
    ensemble: the stretch's (D - 1) ln z is far from its local D's), the
    slice sweep run(4) at 16 x 8 with per-coordinate widths, elliptical
    run(12) at 16 x 32 on a scalar prior and run(8) on a [D] mean and
    [D] scale, tempering run(10) at 16 x 32 with [D] proposal scales and
    two inner sweeps a step. Slice, elliptical and tempering chains that
    differ may first differ by a jump (a flipped decision moves both
    runs), so they are held as NUTS's merges are."""
    out = {}
    calls = [0]
    for name, make, run_args, merges in (
            ("chees", _chees(16, 32, _counting(calls)), (12,), False),
            ("ensemble", _ensemble(32, 8, 16, _counting(calls)), (16,),
             False),
            ("slice", _slice(16, 8, _counting(calls)), (4,), True),
            ("elliptical", _elliptical(16, 32, _counting(calls)), (12,),
             True),
            ("elliptical_vec", _elliptical(
                16, 32, _counting(calls), prior_mean=torch.linspace(
                    -1.0, 1.0, 32), prior_scale=torch.linspace(0.5, 2.0,
                                                               32)),
             (8,), True),
            ("tempering", _tempering(16, 32, _counting(calls)), (10,),
             True)):
        out[name] = _pair(name, lambda: _split(make, mesh), calls,
                          run_args, merges)
    return out


def case_elliptical_dense(mesh):
    """A ``[D, D]`` prior factor on a split: each rank multiplies its
    chains' whole normals by its rows of the factor (a product of another
    shape than the unsplit one, so within rounding): run(8) at 16 x 16,
    the share of chains within 1e-5 of unsharded and their largest
    difference."""
    d = 16
    g = torch.Generator().manual_seed(3)
    a = torch.randn((d, d), generator=g) / d
    chol = torch.linalg.cholesky(a @ a.T + torch.eye(d))
    calls = [0]
    x, y = _split(_elliptical(16, d, _counting(calls), prior_scale=chol),
                  mesh)
    full = x.run(8)
    cube = y.run(8)
    want, got = _block(full, cube)
    err = (got - want).abs().amax(dim=(1, 2))
    ok = err <= 1e-5
    return dict(share=float(ok.float().mean()),
                max_err=float(err[ok].max()) if bool(ok.any()) else None)


def case_chees_adapt(mesh):
    """ChEES ``warmed_up(12)`` and ``warmed_up(8).reconditioned("diag")``
    on float64 states against unsharded: the step size and trajectory
    length (each rank's, for the parent to compare across ranks), the
    metric's slice, the new sampler split, its positions and a run(8)
    after it within 1e-6."""
    out = {}
    for name, adapt in (("warmed", lambda s: s.warmed_up(12)),
                        ("reconditioned",
                         lambda s: s.warmed_up(8).reconditioned("diag"))):
        a, b = _split(_chees(16, 32, dtype=torch.float64), mesh)
        ta, tb = adapt(a), adapt(b)
        res = dict(split=tb._layout is not None
                   and tb._layout.state is not None,
                   placements=tuple(str(p) for p in
                                    tb.state.positions.placements),
                   eps=(ta.step_size, tb.step_size),
                   traj_len=(ta.traj_len, tb.traj_len))
        if ta.metric is not None:
            st, d = tb._layout.state, tb._state.positions.shape[1]
            want = ta.metric.scale.narrow(0, st.d0, d)
            res["metric_err"] = float(
                ((tb.metric.scale.to_local() - want).abs() / want).max())
        res["positions"] = close_match(ta.positions, tb.positions)
        res["run"] = close_match(ta.run(8), tb.run(8))
        out[name] = res
    return out


def case_pt_retuned(mesh):
    """Tempering run(20), then ``retuned()`` and run(6): the new ladder
    (each rank's, for the parent to compare) against unsharded's, the new
    sampler split, its run chain by chain."""
    calls = [0]
    a, b = _split(_tempering(16, 32, _counting(calls), n_inner=1), mesh)
    a.run(20)
    b.run(20)
    ta, tb = a.retuned(), b.retuned()
    x0 = ta.positions.clone()
    return dict(betas=(ta.betas, tb.betas),
                split=tb._layout is not None and tb._layout.state is not None,
                run=chain_match(ta.run(6), tb.run(6), x0, merges=True))


def gate_makes():
    """The gated samplers at their configurations (:data:`GATES`)."""
    g = GATES
    return {
        "chees": lambda: mt.ChEESHMC(
            mt.standard_normal(), mt.init_det(64, g["chees"]["dim"], **CPU),
            CHEES_EPS, seed=SEED, **CPU),
        "ensemble": _ensemble(64, g["ensemble"]["dim"], ENSEMBLE_WALKERS),
        "slice": lambda: mt.SliceSampler(
            mt.standard_normal(), mt.init_det(64, g["slice"]["dim"], **CPU),
            seed=SEED, **CPU),
        "elliptical": _elliptical(
            64, g["elliptical"]["dim"], Target(
                logp=lambda x: -0.5 * torch.sum((x - ELL_MEAN)**2, dim=-1)),
            prior_scale=ELL_PRIOR_SCALE),
        "tempering": lambda: mt.ParallelTempering(
            mt.standard_normal(), mt.init_det(64, g["tempering"]["dim"],
                                              **CPU),
            betas=PT_BETAS, proposal_std=PT_STD, seed=SEED, **CPU),
    }


def _initial_logp(s) -> list:
    """The split state's cached log density (the likelihood's for the
    elliptical sampler, the cold rung's for tempering), whole."""
    st = s.state
    lp = getattr(st, "logp", None)
    if lp is None:
        lp = st.loglik if hasattr(st, "loglik") else st.raw_logp[0]
    return lp.full_tensor().tolist()


def case_gates(mesh):
    """Each sampler's split run at its gate's configuration: the
    per-coordinate means and variances of the whole cube, and the split
    initial state's log density."""
    out = {}
    for name, make in gate_makes().items():
        s = make()
        s.state = shard_sampler_state(mesh, s.state, shard_state_dim=True)
        out[f"{name}_logp"] = _initial_logp(s)
        if name == "chees":
            s = s.warmed_up(CHEES_GATE_WARMUP)
        y = s.run(*GATES[name]["run"]).full_tensor()
        flat = y.reshape(-1, y.shape[-1]).double()
        out[name] = (flat.mean(0).tolist(), flat.var(0).tolist())
    return out


def _refusing_samplers():
    """What the split lockstep samplers still refuse, at D = 4 and 16
    chains (the assignment raises): a transform on each of them, and
    ChEES-HMC with a dense metric."""
    sn = mt.standard_normal()
    x = mt.init_det(16, 4, **CPU).abs() + 0.5
    pos = CoordinateTransform([positive()] * 4)
    return {
        "chees_transform": lambda: mt.ChEESHMC(sn, x, 0.1, transform=pos,
                                               **CPU),
        "ensemble_transform": lambda: mt.EnsembleSampler(
            sn, x, transform=pos, **CPU),
        "slice_transform": lambda: mt.SliceSampler(sn, x, transform=pos,
                                                   **CPU),
        "tempering_transform": lambda: mt.ParallelTempering(
            sn, x, betas=mt.geometric_betas(4, 0.1), transform=pos, **CPU),
        "chees_dense_metric": lambda: mt.ChEESHMC(
            sn, x, 0.1, metric=Preconditioner("dense", chol=torch.eye(4)),
            **CPU),
    }


def case_refusals(mesh):
    """Each refusing sampler's error at the assignment, and
    ``reconditioned("dense")`` on a split ChEES-HMC at the call."""
    out = {}
    for name, make in _refusing_samplers().items():
        try:
            sampler = make()
        except Exception:  # noqa: BLE001 - its construction, reported
            out[name] = "construct: " + traceback.format_exc()
            continue
        out[name] = _error(lambda: _assign(sampler, mesh))
    split = _assign(_chees(16, 8)(), mesh)
    out["chees_reconditioned_dense"] = _error(
        lambda: split.reconditioned("dense"))
    return out


def case_one_rank(mesh):
    """A 1 x 1 mesh runs the unsplit code: each sampler's cube equal bit
    for bit, with no collective of the state axis and none of DTensor's."""
    out = {}
    calls = [0]
    for name, make, run_args in (
            ("chees", _chees(16, 32), (8,)),
            ("ensemble", _ensemble(32, 8, 16), (8,)),
            ("slice", _slice(16, 8), (2,)),
            ("elliptical", _elliptical(16, 32, _counting(calls)), (8,)),
            ("tempering", _tempering(16, 32), (8,))):
        a, b = _split(make, mesh)
        full = a.run(*run_args)
        cube, counts, kinds = _comm(lambda: b.run(*run_args))
        out[name] = dict(equal=bool(torch.equal(full, cube.to_local())),
                         non_scalar=counts["all_reduce"]
                         - counts["all_reduce_scalar"],
                         dtensor=kinds.get("all_reduce", 0))
    return out


def eight_ranks(rank, world):
    """The ``chain_state_mesh(2, 4)`` cases on this rank."""
    mesh = chain_state_mesh(2, 4, device="cpu")
    return _run((("runs", case_runs), ("chees_adapt", case_chees_adapt),
                 ("pt_retuned", case_pt_retuned),
                 ("elliptical_dense", case_elliptical_dense),
                 ("gates", case_gates)), mesh)


def four_ranks(rank, world):
    """The ``(1, 4)`` and ``(2, 2)`` cases on this rank, keyed by mesh."""
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = chain_state_mesh(*shape, device="cpu")
        cases = [("runs", case_runs), ("chees_adapt", case_chees_adapt),
                 ("pt_retuned", case_pt_retuned)]
        if shape == (2, 2):
            cases.append(("refusals", case_refusals))
        for name, res in _run(cases, mesh).items():
            out[f"{name}_{shape[0]}x{shape[1]}"] = res
    return out


def one_rank(rank, world):
    return _run((("one_rank", case_one_rank),),
                chain_state_mesh(1, 1, device="cpu"))
