"""The rank side of ``test_torch_state_mesh_samplers.py``: lockstep MH,
NUTS, SGLD, pSGLD and SGHMC on a state whose D is split over a ``"state"``
axis, and the adaptation (``tuned``, ``reconditioned``, ``warmed_up``) and
a diagonal metric on split HMC, MALA, NUTS and MH. Every case runs on each
rank of one spawned gloo group (``torch_dist.run_ranks``) and returns what
the parent asserts. Imports torch and the port only (the children never
load JAX).

A case builds the same sampler twice from one seed, splits one's state
(``shard_sampler_state(..., shard_state_dim=True)``) and compares the
rank's block of its cube with the same block of the unsharded cube, which
every rank computes itself. A run without adaptation is compared chain by
chain (:func:`chain_match`): the energies are summed in another order, so
a chain whose accept or merge test lies within float32 rounding may
decide the other way. Under adaptation the step size is a continuous
function of those sums, so the split run is compared within a tolerance
(:func:`close_match`).
"""

import io
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.nn.functional as F

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import (
    Preconditioner,
    gaussian_random_walk_proposal,
    isotropic_gaussian_proposal,
    random_walk_int_proposal,
)
from mini_mcmc_torch.models.base import Proposal
from mini_mcmc_torch.models.base import Target
from mini_mcmc_torch.models.transforms import CoordinateTransform, positive
from mini_mcmc_torch.ops.nuts import find_reasonable_epsilon_batch
from mini_mcmc_torch.parallel import (
    chain_state_mesh,
    data_mesh,
    shard_sampler_state,
)
from torch_state_mesh_cases import _assign, _block, _comm, _error, _run

CPU = dict(device="cpu")
#: the JAX gates' configuration: 64 chains x D = 16, run(200, 100)
GATE_C, GATE_D, GATE_RUN = 64, 16, (200, 100)
#: the moment gates of the JAX twin (tests/test_parallel.py:701-732)
MEAN_GATE, VAR_GATE = 0.02, 0.05
SEED = 7
#: the configurations both packages run at the gates
MH_STD, SGLD_EPS, SGHMC_EPS, SGHMC_FRICTION = 0.5, 0.12, 0.05, 0.3
#: positions of a float64 run under adaptation: within this of unsharded
CLOSE_ATOL = 1e-6


def _split(make, mesh):
    """(unsharded sampler, the same sampler with its state split)."""
    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
    return a, b


def chain_match(full, cube, x0, chain_axis: int = 0,
                merges: bool = False) -> dict:
    """The rank's block of ``cube`` (a split run's DTensor cube) against
    the same block of ``full`` (unsharded), chain by chain: the share of
    chains equal bit for bit, whether each differing chain first differs
    at a step where one run moved and the other stayed (a flipped accept)
    or, with ``merges`` (NUTS), jumped (a flipped merge: more than
    rounding apart), the largest difference, and each step's per-chain
    moves (one decision per chain on every shard)."""
    want, got = _block(full, cube, chain_axis)
    if chain_axis == 0:
        want, got = want.transpose(0, 1), got.transpose(0, 1)
    start = x0[None].narrow(2, got.shape[2] * cube.device_mesh
                            .get_local_rank(1), got.shape[2])
    start = start.narrow(1, got.shape[1] * cube.device_mesh
                         .get_local_rank(0), got.shape[1])
    same = (got == want).all(dim=2).all(dim=0)
    moved_a, moved_b = ((torch.cat([start, c])[1:]
                         != torch.cat([start, c])[:-1]).any(dim=2)
                        for c in (want, got))
    differ = (got != want).any(dim=2)
    first = differ.float().argmax(dim=0)[~same]
    cols = (~same).nonzero().flatten()
    jump = (got[first, cols] - want[first, cols]).abs().amax(dim=1)
    flipped = moved_a[first, cols] != moved_b[first, cols]
    return dict(share=float(same.float().mean()),
                decided=bool((flipped | (merges & (jump > 1e-3))).all()),
                max_err=float((got - want).abs().max()),
                moved=moved_b.tolist())


def close_match(full, cube, chain_axis: int = 0) -> dict:
    """The rank's block against unsharded under adaptation: the share of
    chains within :data:`CLOSE_ATOL` everywhere, and the largest
    difference of those chains."""
    want, got = _block(full, cube, chain_axis)
    err = (got - want).abs().movedim(chain_axis, 0).flatten(1).amax(dim=1)
    ok = err <= CLOSE_ATOL
    return dict(share=float(ok.float().mean()),
                max_err=float(err[ok].max()) if bool(ok.any()) else None)


def _counting_normal(calls: list) -> Target:
    """A standard normal whose gradient counts its calls (one a target
    evaluation: the step's start, a leaf, a step-size trial)."""
    def logp(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    def grad(x):
        calls[0] += 1
        return -x

    return Target(logp=logp, grad=grad)


def _mh(c, d, std=MH_STD, **kw):
    return lambda: mt.MetropolisHastings(
        mt.standard_normal(), isotropic_gaussian_proposal(std),
        mt.init_det(c, d, **CPU), seed=SEED, **kw, **CPU)


def _nuts(c, d, target=None, **kw):
    return lambda: mt.NUTS(target or mt.standard_normal(),
                           mt.init_det(c, d, **CPU), seed=SEED, **kw, **CPU)


def _sgld(c, d, grad_fn=None, **kw):
    return lambda: mt.SGLD(grad_fn or mt.target_grad(mt.standard_normal()),
                           mt.init_det(c, d, **CPU), SGLD_EPS, seed=SEED,
                           **kw, **CPU)


def _own_grad(positions, key):
    """A caller's elementwise gradient (a standard normal's), unmarked."""
    del key
    return -positions


def _own_grad_marked(positions, key):
    """The same gradient, marked as taking the rank's D-slice."""
    return _own_grad(positions, key)


_own_grad_marked.takes_state_split = True


def _poisson_iid(lam: float) -> Target:
    """Independent Poisson(``lam``) coordinates over an integer state, the
    log density a sum over D."""
    log_lam = float(np.log(lam))

    def logp(state):
        kf = state.to(torch.float32)
        lp = kf * log_lam - lam - torch.lgamma(kf + 1.0)
        return torch.where(state < 0, -torch.inf, lp).sum(-1)

    return Target(logp=logp)


def _mh_walks(c, d):
    """MH on the other built-in random walks: per-coordinate Gaussian
    scales (a [D] table in the draw and in logp) on a standard normal,
    and the integer walk on independent Poisson coordinates from an int32
    state."""
    scales = torch.linspace(0.3, 0.8, d)
    return (("mh_scales", lambda: mt.MetropolisHastings(
                mt.standard_normal(), gaussian_random_walk_proposal(scales),
                mt.init_det(c, d, **CPU), seed=SEED, **CPU)),
            ("mh_int", lambda: mt.MetropolisHastings(
                _poisson_iid(4.0), random_walk_int_proposal(0),
                torch.full((c, d), 3, dtype=torch.int32), seed=SEED,
                **CPU)))


def _sghmc(c, d, **kw):
    return lambda: mt.SGHMC(mt.target_grad(mt.standard_normal()),
                            mt.init_det(c, d, **CPU), SGHMC_EPS, seed=SEED,
                            friction=SGHMC_FRICTION, **kw, **CPU)


def _hmc(c, d, **kw):
    return lambda: mt.HMC(mt.standard_normal(), mt.init_det(c, d, **CPU),
                          0.15, 5, seed=SEED, **kw, **CPU)


def _mala(c, d, **kw):
    return lambda: mt.MALA(mt.standard_normal(), mt.init_det(c, d, **CPU),
                           0.3, seed=SEED, **kw, **CPU)


def _diag(d):
    return Preconditioner("diag", scale=torch.linspace(0.5, 2.0, d))


def _logistic(d, n=256, b=32):
    """minibatch_grad on a logistic likelihood (``X @ p`` crosses the
    state axis inside) with a standard-normal prior, from seed 5."""
    g = np.random.default_rng(5)
    x = g.standard_normal((n, d)).astype(np.float32)
    y = (g.random(n) < 0.5).astype(np.float32)

    def log_prior(p):
        return -0.5 * torch.sum(p * p)

    def log_like(p, batch):
        xb, yb = batch
        z = xb @ p
        return torch.sum(yb * z - F.softplus(z))

    return mt.minibatch_grad(log_prior, log_like, (x, y), b, **CPU)


def case_runs(mesh):
    """The five new split samplers against unsharded, with their
    collectives: MH run(24) (two all-reduces a step), NUTS run(6) (the
    port's state-axis sums against the target's calls), SGLD, pSGLD and
    SGHMC run(16) on an elementwise gradient (no collective, bit for
    bit), SGLD on a logistic minibatch gradient (10 steps within 1e-5)."""
    out = {}
    a, b = _split(_mh(32, 64), mesh)
    x0 = a.state.positions.clone()
    full = a.run(24)
    cube, counts, kinds = _comm(lambda: b.run(24))
    out["mh"] = dict(chain_match(full, cube, x0), counts=counts,
                     kinds=kinds, steps=24)
    for name, make in _mh_walks(32, 64):
        a, b = _split(make, mesh)
        x0 = a.state.positions.clone()
        full = a.run(24)
        cube, counts, kinds = _comm(lambda: b.run(24))
        out[name] = dict(chain_match(full, cube, x0), counts=counts,
                         kinds=kinds, steps=24)
    calls = [0]
    a, b = _split(_nuts(16, 32, target=_counting_normal(calls)), mesh)
    a.run(1)
    b.run(1)  # the step-size search, outside the count
    x0 = a.state.positions.clone()
    full = a.run(6)
    calls[0] = 0
    cube, counts, kinds = _comm(lambda: b.run(6))
    out["nuts"] = dict(chain_match(full, cube, x0, merges=True),
                       counts=counts,
                       kinds=kinds, calls=calls[0],
                       eps_equal=bool(torch.equal(
                           b._state.epsilon, a._state.epsilon.narrow(
                               0, b._layout.chains.chain0,
                               b._state.epsilon.shape[0]))))
    for name, make in (("sgld", _sgld(16, 64)),
                       ("psgld", _sgld(16, 64, preconditioner="rmsprop")),
                       ("sghmc", _sghmc(16, 64)),
                       ("sgld_own", _sgld(16, 64,
                                          grad_fn=_own_grad_marked))):
        a, b = _split(make, mesh)
        full = a.run(16)
        cube, counts, kinds = _comm(lambda: b.run(16))
        want, got = _block(full, cube)
        extra = {}
        if name == "psgld":
            extra["sq_avg_equal"] = bool(torch.equal(
                _local_block(a._state.sq_avg, b), b._state.sq_avg))
        out[name] = dict(equal=bool(torch.equal(want, got)), counts=counts,
                         kinds=kinds, **extra)
    grad_fn = _logistic(64)
    a, b = _split(lambda: mt.SGLD(grad_fn, mt.init_det(16, 64, **CPU), 1e-3,
                                  seed=SEED, **CPU), mesh)
    full = a.run(10)
    cube, counts, kinds = _comm(lambda: b.run(10))
    want, got = _block(full, cube)
    out["sgld_logistic"] = dict(err=float((want - got).abs().max()),
                                counts=counts, kinds=kinds)
    return out


def _local_block(full: torch.Tensor, sampler) -> torch.Tensor:
    """The rows and D-slice of the unsharded ``[C, D]`` tensor ``full``
    that the split ``sampler`` holds on this rank."""
    chains, st = sampler._layout.chains, sampler._layout.state
    c, d = sampler._state.positions.shape
    return full.narrow(0, chains.chain0, c).narrow(1, st.d0, d)


def case_metric(mesh):
    """A diagonal ``metric=`` on split HMC, MALA and NUTS (no
    adaptation): each chain's block against unsharded, the rows mapped
    through the metric's slice."""
    out = {}
    for name, make, n in (("hmc", _hmc(16, 32, metric=_diag(32)), 12),
                          ("mala", _mala(16, 32, metric=_diag(32)), 12),
                          ("nuts", _nuts(16, 32, metric=_diag(32)), 4)):
        a, b = _split(make, mesh)
        x0 = a.positions.clone()
        full = a.run(n)
        cube = b.run(n)
        out[name] = chain_match(full, cube, x0, merges=name == "nuts")
    return out


def _f64(c, d):
    return mt.init_det(c, d, **CPU).double()


#: the adaptation cases, on float64 states: the dual averaging's first
#: iterations amplify a difference in the mean acceptance (its gain
#: sqrt(m) / (gamma (m + t0)) times the acceptance's slope in log eps
#: exceeds 1), so float32 rounding of the reordered sums grows to percents
#: of the tuned step size within a dozen steps, split or not; in float64
#: it stays far below the tolerances
ADAPT_CASES = (
    ("hmc_tuned", lambda: mt.HMC(mt.standard_normal(), _f64(16, 32), 0.15,
                                 5, seed=SEED, **CPU),
     lambda s: s.tuned(20)),
    ("hmc_warmed", lambda: mt.HMC(mt.standard_normal(), _f64(16, 32), 0.15,
                                  5, seed=SEED, **CPU),
     lambda s: s.warmed_up(12)),
    ("hmc_reconditioned", lambda: mt.HMC(mt.standard_normal(),
                                         _f64(16, 32), 0.15, 5, seed=SEED,
                                         **CPU),
     lambda s: s.tuned(12).reconditioned("diag")),
    ("mala_warmed", lambda: mt.MALA(mt.standard_normal(), _f64(16, 32),
                                    0.3, seed=SEED, **CPU),
     lambda s: s.warmed_up(12)),
    ("nuts_warmed", lambda: mt.NUTS(mt.standard_normal(), _f64(16, 32),
                                    seed=SEED, **CPU),
     lambda s: s.warmed_up(6)),
    ("mh_tuned", lambda: mt.MetropolisHastings(
        mt.standard_normal(), isotropic_gaussian_proposal(MH_STD),
        _f64(16, 32), seed=SEED, **CPU),
     lambda s: s.tuned(20)),
)


def case_adapt(mesh):
    """``tuned`` / ``reconditioned("diag")`` / ``warmed_up("diag")`` on
    split HMC, MALA and NUTS and ``tuned`` on split MH, against the same
    calls unsharded: the tuned step size or factor, the metric's slice,
    the new sampler split, and a run after it within tolerance."""
    out = {}
    for name, make, adapt in ADAPT_CASES:
        a, b = _split(make, mesh)
        ta, tb = adapt(a), adapt(b)
        res = dict(split=tb._layout is not None
                   and tb._layout.state is not None,
                   placements=tuple(str(p) for p in
                                    tb.state.positions.placements))
        if name.startswith("mh"):
            res["factor"] = (ta.scale_factor, tb.scale_factor)
        elif not name.startswith("nuts"):
            res["eps"] = (ta.step_size, tb.step_size)
        if getattr(ta, "metric", None) is not None:
            st, d = tb._layout.state, tb._state.positions.shape[1]
            want = ta.metric.scale.narrow(0, st.d0, d)
            res["metric_err"] = float(
                ((tb.metric.scale.to_local() - want).abs() / want).max())
            res["sigma_min"] = (ta.metric.sigma_min(), tb.metric.sigma_min())
        res["positions"] = close_match(ta.positions, tb.positions)
        run = (4, 4) if name.startswith("nuts") else (8, 0)
        res["run"] = close_match(ta.run(*run), tb.run(*run))
        out[name] = res
    return out


def case_tools(mesh):
    """run_progress, stream_run and a checkpoint round-trip of each new
    split sampler (no adaptation): the progress cube and R-hat, the
    stream's live R-hat and acceptance against unsharded; the checkpoint
    file equal to the unsharded one's, restored split, continuing bit for
    bit."""
    from mini_mcmc_torch.checkpoint import (
        load_checkpoint,
        restore_sampler,
        save_sampler,
    )
    import torch.distributed as dist

    root = os.path.join(tempfile.gettempdir(),
                        f"mm_torch_state_samplers_{os.getppid()}")
    os.makedirs(root, exist_ok=True)
    rank = dist.get_rank()
    out = {}
    makes = {"mh": _mh(16, 32), "nuts": _nuts(16, 32),
             "sgld": _sgld(16, 32), "psgld": _sgld(
                 16, 32, preconditioner="rmsprop"),
             "sghmc": _sghmc(16, 32), "hmc_metric": _hmc(
                 16, 32, metric=_diag(32))}
    for name, make in makes.items():
        res = {}
        a, b = _split(make, mesh)
        x0 = a.positions.clone()
        pa, sa = a.run_progress(8, stream=io.StringIO())
        pb, sb = b.run_progress(8, stream=io.StringIO())
        res["progress"] = chain_match(pa, pb, x0, merges=name == "nuts")
        res["progress_rhat"] = (float(sa.rhat.mean), float(sb.rhat.mean))
        ra = mt.stream_run(a, 8, 4)
        rb = mt.stream_run(b, 8, 4)
        res["stream_rhat"] = (ra.rhat.tolist(), rb.rhat.tolist())
        res["stream_p"] = (float(ra.p_accept.mean()),
                           float(rb.p_accept.mean()))
        mine = os.path.join(root, f"{name}_unsharded_{rank}")
        shared = os.path.join(root, f"{name}_split")
        save_sampler(mine, a)
        save_sampler(shared, b)
        want, _ = load_checkpoint(mine, device="cpu")
        got, _ = load_checkpoint(shared, device="cpu")
        res["file"] = {f: bool(torch.allclose(
            torch.as_tensor(getattr(want, f)).double(),
            torch.as_tensor(getattr(got, f)).double(), rtol=1e-5,
            atol=1e-6)) for f in want._fields}
        c = make().seed(99)
        c.state = shard_sampler_state(mesh, c.state, shard_state_dim=True)
        restore_sampler(shared, c)
        res["restored_split"] = c._layout.state is not None
        res["continues"] = bool(torch.equal(b.run(4).to_local(),
                                            c.run(4).to_local()))
        out[name] = res
    return out


def case_find_eps(mesh):
    """The reference input of ``find_reasonable_epsilon`` (a standard
    normal at [0, 1] with momentum [1, 0], float64, the golden 2.0) on
    4 chains split 2 x 2: every rank's result."""
    f64 = dict(dtype=torch.float64)
    pos = torch.tensor([[0.0, 1.0]] * 4, **f64)
    mom = torch.tensor([[1.0, 0.0]] * 4, **f64)
    split = shard_sampler_state(mesh, pos, shard_state_dim=True)
    moms = shard_sampler_state(mesh, mom, shard_state_dim=True)
    from mini_mcmc_torch.parallel.mesh import local_state

    local, layout = local_state(split)
    eps = find_reasonable_epsilon_batch(mt.standard_normal(), local,
                                        moms.to_local(), layout.state)
    return eps.tolist()


def case_gates(mesh):
    """The JAX twin's moment gates on the split run(200, 100) at 64 x 16
    of MH, NUTS, SGLD and SGHMC, and the split initial logp (MH's state)
    whole on every rank."""
    out = {}
    for name, make in (("mh", _mh(GATE_C, GATE_D)),
                       ("nuts", _nuts(GATE_C, GATE_D)),
                       ("sgld", _sgld(GATE_C, GATE_D)),
                       ("sghmc", _sghmc(GATE_C, GATE_D))):
        s = make()
        s.state = shard_sampler_state(mesh, s.state, shard_state_dim=True)
        if name == "mh":
            out["mh_logp"] = s.state.logp.full_tensor().tolist()
        y = s.run(*GATE_RUN).full_tensor()
        out[name] = (float(y.mean()), float(y.var()))
    return out


def _refusing_samplers():
    """The samplers and options this slice adds to the refusals, at D = 4
    and 16 chains (the assignment raises)."""
    sn = mt.standard_normal()
    x = mt.init_det(16, 4, **CPU)
    walk = isotropic_gaussian_proposal(1.0)
    dense = Preconditioner("dense", chol=torch.eye(4))
    unmarked = Proposal(sample=walk.sample, logp=walk.logp, symmetric=True)
    return {
        "mh_unmarked_proposal": lambda: mt.MetropolisHastings(
            sn, unmarked, x, **CPU),
        "sgld_unmarked_grad_fn": lambda: mt.SGLD(_own_grad, x, 1e-3, **CPU),
        "sghmc_unmarked_grad_fn": lambda: mt.SGHMC(_own_grad, x, 1e-3,
                                                   **CPU),
        "nuts_true": lambda: mt.NUTS(sn, x, use_pallas=True, **CPU),
        "nuts_full": lambda: mt.NUTS(sn, x, use_pallas="full", **CPU),
        "mh_full": lambda: mt.MetropolisHastings(sn, walk, x,
                                                 use_pallas="full", **CPU),
        "dense_metric": lambda: mt.HMC(sn, x, 0.1, 3, metric=dense, **CPU),
        "transform": lambda: mt.HMC(
            sn, x.abs() + 0.5, 0.1, 3, transform=CoordinateTransform(
                [positive()] * 4), **CPU),
    }


def case_refusals(mesh):
    """Each refusing sampler's error at the assignment, SGLD with
    data_parallel_grad at its assignment and the gradient's call, and
    reconditioned("dense") on a split HMC."""
    out = {}
    for name, make in _refusing_samplers().items():
        try:
            sampler = make()
        except Exception:  # noqa: BLE001 - its construction, reported
            out[name] = "construct: " + traceback.format_exc()
            continue
        out[name] = _error(lambda: _assign(sampler, mesh))
    dmesh = data_mesh(device="cpu")
    dpg = mt.data_parallel_grad(lambda p: -0.5 * torch.sum(p * p),
                                lambda p, b: torch.sum(b[:, 0]) * 0.0,
                                torch.zeros(16, 1), 4, dmesh)
    sgld = mt.SGLD(dpg, mt.init_det(16, 4, **CPU), 1e-3, **CPU)
    out["data_parallel_grad"] = _error(lambda: _assign(sgld, mesh))
    from mini_mcmc_torch.parallel.mesh import local_state
    from mini_mcmc_torch.runner import StepKey

    _, layout = local_state(shard_sampler_state(
        mesh, torch.zeros(16, 4), shard_state_dim=True))
    key = StepKey(0, 0, torch.Generator(), layout.chains, layout.state)
    out["data_parallel_grad_call"] = _error(
        lambda: dpg(torch.zeros(8, 2), key))
    split = _assign(_hmc(16, 8)(), mesh)
    out["reconditioned_dense"] = _error(lambda: split.reconditioned("dense"))
    return out


def case_one_rank(mesh):
    """A 1 x 1 mesh runs the unsplit code: MH, NUTS, SGLD and SGHMC cubes
    equal bit for bit, with no collective of the state axis."""
    out = {}
    for name, make, run in (("mh", _mh(16, 32), (8,)),
                            ("nuts", _nuts(16, 32), (4, 4)),
                            ("sgld", _sgld(16, 32), (8,)),
                            ("sghmc", _sghmc(16, 32), (8,))):
        a, b = _split(make, mesh)
        full = a.run(*run)
        cube, counts, kinds = _comm(lambda: b.run(*run))
        out[name] = dict(equal=bool(torch.equal(full, cube.to_local())),
                         non_scalar=counts["all_reduce"]
                         - counts["all_reduce_scalar"], kinds=kinds)
    return out


def eight_ranks(rank, world):
    """The ``chain_state_mesh(2, 4)`` cases on this rank."""
    mesh = chain_state_mesh(2, 4, device="cpu")
    return _run((("runs", case_runs), ("metric", case_metric),
                 ("adapt", case_adapt), ("gates", case_gates)), mesh)


def four_ranks(rank, world):
    """The ``(1, 4)`` and ``(2, 2)`` cases on this rank, keyed by mesh."""
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = chain_state_mesh(*shape, device="cpu")
        cases = [("runs", case_runs), ("adapt", case_adapt)]
        if shape == (2, 2):
            cases += [("tools", case_tools), ("find_eps", case_find_eps),
                      ("refusals", case_refusals),
                      ("metric", case_metric)]
        for name, res in _run(cases, mesh).items():
            out[f"{name}_{shape[0]}x{shape[1]}"] = res
    return out


def one_rank(rank, world):
    return _run((("one_rank", case_one_rank),),
                chain_state_mesh(1, 1, device="cpu"))
