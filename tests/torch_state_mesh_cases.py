"""The rank side of ``test_torch_state_mesh.py``: every case runs on each
rank of one spawned gloo group (``torch_dist.run_ranks``), eight ranks for
the ``chain_state_mesh(2, 4)`` cases and four for the ``(1, 4)`` and
``(2, 2)`` ones, and returns what the parent asserts. Imports torch and the
port only (the children never load JAX).

A case builds the same sampler twice from one seed, splits one's state
over the mesh (``shard_sampler_state(..., shard_state_dim=True)``) and
compares the rank's block of its cube with the same block of the
unsharded cube, which every rank computes itself. Collectives are counted
twice: ``parallel.collectives.COUNTS`` (the port's own calls) and
``torch.distributed.tensor.debug.CommDebugMode`` (every collective,
DTensor's included), by kind.
"""

import io
import os
import tempfile
import traceback
from typing import NamedTuple

import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import rosenbrock_nd
from mini_mcmc_torch.models.base import Target
from mini_mcmc_torch.parallel import (
    chain_sharding,
    chain_state_mesh,
    collectives,
    shard_chains,
    shard_sampler_state,
)

CPU = dict(device="cpu")
#: the JAX twin's configuration (tests/test_parallel.py:701-732)
C, D, EPS, L, SEED = 64, 512, 0.15, 5, 7


def _block(full: torch.Tensor, sharded, chain_axis: int = 0):
    """The rank's block of ``full`` (chains on ``chain_axis``, D last) and
    ``sharded``'s local tensor."""
    local = sharded.to_local()
    mesh = sharded.device_mesh
    c, d = local.shape[chain_axis], local.shape[-1]
    want = full.narrow(chain_axis, mesh.get_local_rank(0) * c, c)
    return want.narrow(-1, mesh.get_local_rank(1) * d, d), local


def _equal_block(full, sharded, chain_axis: int = 0) -> bool:
    want, got = _block(full, sharded, chain_axis)
    return bool(torch.equal(want, got))


def _max_err(full, sharded, chain_axis: int = 0) -> float:
    want, got = _block(full, sharded, chain_axis)
    return float((want - got).abs().max())


def _comm(fn):
    """``(fn(), the port's counts, every collective by kind)``."""
    from torch.distributed.tensor.debug import CommDebugMode

    collectives.reset_counts()
    with CommDebugMode() as mode:
        out = fn()
    kinds = {}
    for op, n in mode.get_comm_counts().items():
        name = str(op).split(".")[-1].rstrip("_")
        kinds[name] = kinds.get(name, 0) + n
    return out, collectives.counts(), kinds


def _split_pair(make, mesh):
    """(unsharded sampler, the same sampler with its state split, the
    collectives of the assignment)."""
    a, b = make(), make()
    collectives.reset_counts()
    b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
    return a, b, collectives.counts()


def _hmc(c=C, d=D, target=None, **kw):
    def make():
        return mt.HMC(target or mt.standard_normal(),
                      mt.init_det(c, d, **CPU), EPS, L, seed=SEED, **kw,
                      **CPU)
    return make


def case_layout_moments(mesh):
    """The JAX twin's setup: initial logp and grad, the positions' layout,
    run(200, 100)'s moments of both runs."""
    a, b, assign = _split_pair(_hmc(), mesh)
    pos = b.state.positions
    init = dict(
        logp=bool(torch.allclose(b.state.logp.full_tensor(), a.state.logp,
                                 rtol=1e-6)),
        grad=bool(torch.allclose(b.state.grad.full_tensor(), a.state.grad,
                                 rtol=1e-6)),
        placements=tuple(str(p) for p in pos.placements),
        global_shape=tuple(pos.shape), local=tuple(pos.to_local().shape),
        mesh_size=pos.device_mesh.size(), dim=b.dim, n_chains=b.n_chains)
    x = a.run(200, 100)
    y = b.run(200, 100).full_tensor()
    return dict(init=init, assign=assign, moments=(
        float(x.mean()), float(x.var()), float(y.mean()), float(y.var())))


def case_short_runs(mesh):
    """run(20) of lockstep HMC, MALA, a density holding a plain [D] scale
    table (implicitly replicated on the DTensor view) and a coupled density
    (Rosenbrock, whose DTensor view redistributes) against unsharded, and
    each chain's accept decisions on this rank's D-slice."""
    out = {}
    for name, make in (
            ("hmc", _hmc()),
            ("hmc_jitter", _hmc(jitter=0.2, steps_per_call=4)),
            ("hmc_table", _hmc(target=_scaled_normal(D))),
            ("mala", lambda: mt.MALA(mt.standard_normal(),
                                     mt.init_det(C, D, **CPU), 0.3,
                                     seed=SEED, **CPU)),
            ("rosenbrock", lambda: mt.HMC(rosenbrock_nd(),
                                          mt.init_det(16, 8, **CPU), 0.01,
                                          3, seed=SEED, **CPU))):
        a, b, _ = _split_pair(make, mesh)
        full = a.run(20)
        cube = b.run(20)
        local = cube.to_local()
        moved = (local[:, 1:] != local[:, :-1]).any(dim=2)
        out[name] = dict(
            err=_max_err(full, cube), equal=_equal_block(full, cube),
            moved=moved.tolist(), logp_err=float(
                (b.state.logp.full_tensor() - a.state.logp).abs().max()))
    return out


def case_all_reduce_only(mesh):
    """The twin of ``test_state_dim_sharded_scan_all_reduce_only``: 16 x
    1,024, run(32, 8) counted."""
    a, b, assign = _split_pair(_hmc(16, 1024), mesh)
    _, counts, kinds = _comm(lambda: b.run(32, 8))
    return dict(assign=assign, counts=counts, kinds=kinds)


def _scaled_normal(d):
    """A user coordinate functor with a per-coordinate table: N(0, s^2)
    with s from 0.5 to 2 over the coordinates."""
    s = torch.linspace(0.5, 2.0, d)

    def tile(x, s):
        return torch.sum(-0.5 * (x / s) ** 2 - torch.log(s), dim=-1)

    return Target(logp=lambda x: tile(x, s), sep_form=(tile, (s,)))


def case_separable(mesh):
    """The separable tier at D = 2,048: one step's positions bit for bit,
    the energies at rtol 1e-5, one all-reduce a step."""
    out = {}
    for name, target in (("normal", mt.standard_normal()),
                         ("table", _scaled_normal(2048))):
        make = _hmc(16, 2048, target=target, use_pallas="separable")
        a, b, _ = _split_pair(make, mesh)
        full, cube = a.run(1), b.run(1)
        logp_close = bool(torch.allclose(b.state.logp.full_tensor(),
                                         a.state.logp, rtol=1e-5))
        cube4, counts, kinds = _comm(lambda: b.run(4))
        out[name] = dict(equal=_equal_block(full, cube),
                         logp_close=logp_close, counts=counts, kinds=kinds,
                         err4=_max_err(a.run(4), cube4))
    return out


def case_diagnostics(mesh):
    """split R-hat and ESS, rank diagnostics and summary of a state-split
    cube against the same cube whole; run_progress and stream_run's
    trackers against unsharded."""
    a, b, _ = _split_pair(_hmc(32, 16), mesh)
    full = a.run(64, 16, time_major=True)
    cube = b.run(64, 16, time_major=True)
    whole = cube.full_tensor()
    cm = b.run(48)
    cm_whole = cm.full_tensor()

    def close(x, y):
        return bool(torch.allclose(torch.as_tensor(x), torch.as_tensor(y),
                                   rtol=1e-6, atol=1e-6))

    r, e = mt.split_rhat_mean_ess(cube, time_major=True)
    r0, e0 = mt.split_rhat_mean_ess(whole, time_major=True)
    rc, ec = mt.split_rhat_mean_ess(cm)
    rc0, ec0 = mt.split_rhat_mean_ess(cm_whole)
    rank = mt.rank_normalized_diagnostics(cube, time_major=True)
    rank0 = mt.rank_normalized_diagnostics(whole, time_major=True)
    sm, sm0 = mt.summary(cm), mt.summary(cm_whole)
    a2, b2, _ = _split_pair(_hmc(32, 16), mesh)
    pa, sa = a2.run_progress(24, 8, stream=io.StringIO())
    pb, sb = b2.run_progress(24, 8, stream=io.StringIO())
    a3, b3, _ = _split_pair(_hmc(32, 16), mesh)
    ra = mt.stream_run(a3, 16, 4, n_discard=8)
    rb = mt.stream_run(b3, 16, 4, n_discard=8)
    return dict(
        cube_equal=_equal_block(full, cube, 1),
        rhat=close(r, r0) and close(rc, rc0) and r.shape == (16,),
        ess=close(e, e0) and close(ec, ec0),
        rank=all(close(getattr(rank, f), getattr(rank0, f))
                 for f in ("rhat", "rhat_bulk", "rhat_folded", "ess_bulk",
                           "ess_tail")),
        summary=all(close(getattr(sm, f), getattr(sm0, f))
                    for f in ("mean", "sd", "mcse_mean", "mcse_sd",
                              "quantiles", "ess_bulk", "ess_tail", "rhat")),
        progress_equal=_equal_block(pa, pb),
        progress_rhat=(sb.rhat.mean, sa.rhat.mean, sb.ess.mean,
                       sa.ess.mean),
        stream_rhat=(ra.rhat.tolist(), rb.rhat.tolist()),
        stream_p=(float(ra.p_accept), float(rb.p_accept)))


def case_checkpoint(mesh):
    """save_sampler on a state-split run: at the assignment the file is
    the unsharded one's bit for bit; after run(8) the positions and the
    gradient are, the cached logp within 1e-5 (summed over the slices);
    restore_sampler into another split sampler continues bit for bit."""
    from mini_mcmc_torch.checkpoint import (
        load_checkpoint,
        restore_sampler,
        save_sampler,
    )
    import torch.distributed as dist

    root = os.path.join(tempfile.gettempdir(),
                        f"mm_torch_state_mesh_{os.getppid()}")
    os.makedirs(root, exist_ok=True)
    rank = dist.get_rank()
    make = _hmc(16, 64)
    a, b, _ = _split_pair(make, mesh)
    out = {}
    for when in ("assigned", "after_run"):
        if when == "after_run":
            a.run(8)
            b.run(8)
        mine = os.path.join(root, f"unsharded_{when}_{rank}")
        shared = os.path.join(root, f"split_{when}")
        save_sampler(mine, a)
        save_sampler(shared, b)
        want, _ = load_checkpoint(mine, device="cpu")
        got, _ = load_checkpoint(shared, device="cpu")
        out[when] = {f: (bool(torch.equal(getattr(want, f),
                                          getattr(got, f))),
                         bool(torch.allclose(getattr(want, f),
                                             getattr(got, f), rtol=1e-5)))
                     for f in want._fields}
    c = make().seed(99)
    c.state = shard_sampler_state(mesh, c.state, shard_state_dim=True)
    restore_sampler(shared, c)
    out["restored_split"] = c._layout.state is not None
    out["continues"] = bool(torch.equal(b.run(4).to_local(),
                                        c.run(4).to_local()))
    return out


def case_guards(mesh):
    """The refusals and layout rules, each error's text or None."""
    out = {}

    class Tabled(NamedTuple):
        positions: torch.Tensor
        table: torch.Tensor  # [C, 3]: its last axis is not D
        STATE_AXIS_INDEX = {"positions": 1}

    world = mesh.size()
    t = shard_sampler_state(mesh, Tabled(torch.zeros(16, 8),
                                         torch.zeros(16, 3)),
                            shard_state_dim=True)
    out["tabled"] = (tuple(str(p) for p in t.positions.placements),
                     tuple(str(p) for p in t.table.placements),
                     tuple(t.positions.to_local().shape))
    # chains alone on a 2-D mesh: the state axis replicated
    x = shard_chains(mesh, torch.zeros(16, 8))
    out["chains_only"] = (tuple(str(p) for p in x.placements),
                          tuple(chain_sharding(mesh).placements)
                          == tuple(x.placements),
                          tuple(x.to_local().shape))
    n_state = mesh.size(1)
    cases = {
        "too_few_ranks": lambda: chain_state_mesh(world, 4, device="cpu"),
        "indivisible": lambda: shard_sampler_state(
            mesh, mt.HMC(mt.standard_normal(),
                         mt.init_det(16, 4 * n_state + 1, **CPU), 0.1, 3,
                         **CPU).state, shard_state_dim=True),
        "separable_quads": lambda: _assign(mt.HMC(
            mt.standard_normal(), mt.init_det(16, 2 * n_state, **CPU), 0.1,
            3, use_pallas="separable", **CPU), mesh),
    }
    for name, fn in cases.items():
        out[name] = _error(fn)
    return out


def _assign(sampler, mesh):
    sampler.state = shard_sampler_state(mesh, sampler.state,
                                        shard_state_dim=True)
    return sampler


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _refusing_samplers():
    """Every sampler and tier that refuses a split D, at D = 4, 16 chains
    (Gibbs at its own D); the split samplers' own refusals are
    ``torch_state_mesh_sampler_cases.py``'s and
    ``torch_state_mesh_lockstep_cases.py``'s."""
    sn = mt.standard_normal()
    x = mt.init_det(16, 4, **CPU)
    return {
        "hmc_true": lambda: mt.HMC(sn, x, 0.1, 3, use_pallas=True, **CPU),
        "hmc_full": lambda: mt.HMC(sn, x, 0.1, 3, use_pallas="full", **CPU),
        "mala_full": lambda: mt.MALA(sn, x, 0.1, use_pallas="full", **CPU),
        "gibbs": lambda: mt.GibbsSampler(
            mt.gaussian_mixture_conditional(-2, 1, 3, 1.5, 0.5),
            torch.zeros(16, 2), **CPU),
        "tempering": lambda: mt.ParallelTempering(
            sn, x, betas=mt.geometric_betas(4, 0.1), use_pallas="full",
            **CPU),
    }


def case_refusals(mesh):
    """Each refusing sampler's error at the assignment and make_anneal's
    anneal on a split x0."""
    out = {}
    for name, make in _refusing_samplers().items():
        try:
            sampler = make()
        except Exception:  # noqa: BLE001 - its construction, reported
            out[name] = "construct: " + traceback.format_exc()
            continue
        out[name] = _error(lambda: _assign(sampler, mesh))
    from mini_mcmc_torch.ops.ais import make_anneal

    anneal = make_anneal(mt.standard_normal(), (0.5, 1.0))
    x0 = shard_sampler_state(mesh, torch.zeros(16, 4), shard_state_dim=True)
    out["ais"] = _error(lambda: anneal(x0, torch.Generator()))
    return out


def case_one_rank(mesh):
    """A 1 x 1 mesh runs the unsplit code: lockstep and separable cubes
    equal bit for bit, the same twin calls, no collective."""
    from mini_mcmc_torch.ops.kernels import hmc_sep

    out = {}
    for name, make in (("lockstep", _hmc(16, 64)),
                       ("separable", _hmc(16, 60, use_pallas="separable"))):
        a, b, assign = _split_pair(make, mesh)
        calls = hmc_sep.hmc_separable_step_plain.calls
        full = a.run(8, 4)
        calls_a = hmc_sep.hmc_separable_step_plain.calls - calls
        cube, counts, kinds = _comm(lambda: b.run(8, 4))
        calls_b = hmc_sep.hmc_separable_step_plain.calls - calls - calls_a
        out[name] = dict(equal=bool(torch.equal(full, cube.to_local())),
                         placements=tuple(str(p) for p in cube.placements),
                         calls=(calls_a, calls_b), assign=assign,
                         counts=counts, kinds=kinds)
    return out


def _run(cases, mesh):
    out = {}
    for name, fn in cases:
        try:
            out[name] = ("ok", fn(mesh))
        except Exception:  # noqa: BLE001 - reported per case
            out[name] = ("error", traceback.format_exc())
    return out


def eight_ranks(rank, world):
    """The ``chain_state_mesh(2, 4)`` cases on this rank: ``{case: ("ok",
    result) | ("error", traceback)}``."""
    mesh = chain_state_mesh(2, 4, device="cpu")
    return _run((("layout_moments", case_layout_moments),
                 ("short_runs", case_short_runs),
                 ("all_reduce_only", case_all_reduce_only),
                 ("diagnostics", case_diagnostics),
                 ("checkpoint", case_checkpoint),
                 ("guards", case_guards)), mesh)


def one_rank(rank, world):
    return _run((("one_rank", case_one_rank),),
                chain_state_mesh(1, 1, device="cpu"))


def four_ranks(rank, world):
    """The ``(1, 4)`` and ``(2, 2)`` cases on this rank, keyed by mesh."""
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = chain_state_mesh(*shape, device="cpu")
        cases = [("separable", case_separable), ("guards", case_guards)]
        if shape == (2, 2):
            cases.append(("refusals", case_refusals))
        for name, res in _run(cases, mesh).items():
            out[f"{name}_{shape[0]}x{shape[1]}"] = res
    return out
