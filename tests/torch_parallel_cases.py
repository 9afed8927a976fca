"""The rank side of ``test_torch_parallel.py``: every case runs on each rank
of one spawned gloo group (``torch_dist.run_ranks``) and returns what the
parent asserts. Imports torch and the port only (the children never load
JAX); the parent holds the numbers that need JAX.

A case builds the same sampler twice from one seed, shards one over the
chain mesh and compares the rank's rows of its cube with the same rows of
the unsharded cube, which every rank computes itself; the collective
counts come from ``parallel.collectives.COUNTS``.
"""

import os
import tempfile
import traceback

import numpy as np
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.models import (
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
    rosenbrock_nd,
)
from mini_mcmc_torch.models.base import Target
from mini_mcmc_torch.parallel import (
    chain_mesh,
    chain_sharding,
    collectives,
    data_mesh,
    replicated_sharding,
    shard_chains,
    shard_sampler_state,
)

CPU = dict(device="cpu")


def _rows(full: torch.Tensor, sharded, axis: int = 0):
    """The rank's rows of ``full`` and ``sharded``'s local tensor."""
    local = sharded.to_local()
    n = local.shape[axis]
    start = sharded.device_mesh.get_local_rank(0) * n
    return full.narrow(axis, start, n), local


def _equal_rows(full, sharded, axis: int = 0) -> bool:
    want, got = _rows(full, sharded, axis)
    return bool(torch.equal(want, got))


def _counted(fn):
    """``(fn(), collective counts during it)``."""
    collectives.reset_counts()
    out = fn()
    return out, collectives.counts()


def _pair(make, mesh, n_collect, n_discard, **kw):
    """(unsharded cube, sharded cube, counts of the sharded run)."""
    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state)
    full = a.run(n_collect, n_discard, **kw)
    cube, counts = _counted(lambda: b.run(n_collect, n_discard, **kw))
    return full, cube, counts


def case_layout(mesh, world):
    x = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    xs = shard_chains(mesh, x)
    from mini_mcmc_torch.ops.sgmcmc import SGLDState

    sg = shard_sampler_state(mesh, SGLDState(x, torch.zeros(()), 0))
    placed = (tuple(xs.placements) == chain_sharding(mesh).placements
              and tuple(sg.sq_avg.placements)
              == replicated_sharding(mesh).placements and sg.step == 0)
    hmc = mt.HMC(rosenbrock_nd(), mt.init_det(16, 3, **CPU), 0.03, 5,
                 **CPU).seed(4)
    hmc.state = shard_sampler_state(mesh, hmc.state)
    sample = hmc.run(10, 0)
    tm = hmc.run(6, 0, time_major=True)
    return dict(mesh_size=mesh.size(), local=tuple(xs.to_local().shape),
                placements=placed,
                global_shape=tuple(xs.shape), rows_equal=_equal_rows(x, xs),
                cube_shape=tuple(sample.shape),
                cube_placement=str(sample.placements[0]),
                tm_placement=str(tm.placements[0]),
                n_chains=hmc.n_chains)


def case_hmc(mesh, world):
    out = {}
    for tier, kw in (("plain", {}), ("true", dict(use_pallas=True)),
                     ("full", dict(use_pallas="full", steps_per_call=4)),
                     ("jitter", dict(jitter=0.2))):
        def make(kw=kw):
            return mt.HMC(rosenbrock_nd(), mt.init_det(16, 3, **CPU), 0.02,
                          5, seed=4, **kw, **CPU)
        full, cube, counts = _pair(make, mesh, 8, 4)
        full_tm, cube_tm, _ = _pair(make, mesh, 8, 4, time_major=True)
        out[tier] = dict(equal=_equal_rows(full, cube),
                         equal_tm=_equal_rows(full_tm, cube_tm, 1),
                         collectives=_total(counts))
    return out


def case_mh(mesh, world):
    out = {}
    for tier, kw in (("plain", {}),
                     ("full", dict(use_pallas="full", steps_per_call=5))):
        def make(kw=kw):
            return mt.MetropolisHastings(
                gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                isotropic_gaussian_proposal(1.0), mt.init_det(64, 2, **CPU),
                seed=0, **kw, **CPU)
        full, cube, counts = _pair(make, mesh, 20, 10)
        out[tier] = dict(equal=_equal_rows(full, cube),
                         collectives=_total(counts))
    # the int32 Poisson walk draws through its proposal's sample()
    def poisson():
        return mt.MetropolisHastings(
            mt.poisson_target(4.0), mt.random_walk_int_proposal(),
            torch.zeros((32, 1), dtype=torch.int32), seed=3, **CPU)
    full, cube, _ = _pair(poisson, mesh, 20, 0)
    out["poisson"] = dict(equal=_equal_rows(full, cube), collectives=0)
    return out


def _heavy(counts) -> int:
    """Collectives other than all-reduces."""
    return counts["all_gather"] + counts["broadcast"] + counts["barrier"]


def _total(counts) -> int:
    return _heavy(counts) + counts["all_reduce"]


def case_nuts(mesh, world):
    out = {}
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    for tier, kw in (("plain", {}), ("true", dict(use_pallas=True)),
                     ("full", dict(use_pallas="full"))):
        def make(kw=kw):
            return mt.NUTS(target, mt.init_det(16, 2, **CPU), 0.8, seed=7,
                           max_depth=6, **kw, **CPU)
        a, b = make(), make()
        b.state = shard_sampler_state(mesh, b.state)
        full = a.run(6, 6)
        cube, counts = _counted(lambda: b.run(6, 6))
        eps_want, eps_got = _rows(a.step_size, b.step_size)
        lf_want, lf_got = _rows(a.leapfrogs, b.leapfrogs)
        out[tier] = dict(equal=_equal_rows(full, cube),
                         eps_equal=bool(torch.equal(eps_want, eps_got)),
                         leapfrogs_equal=bool(torch.equal(lf_want, lf_got)),
                         heavy=_heavy(counts),
                         all_reduce=counts["all_reduce"],
                         scalar=counts["all_reduce_scalar"])
    return out


def case_tempering(mesh, world):
    out = {}
    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    for tier, kw in (("plain", {}),
                     ("full", dict(use_pallas="full", steps_per_call=4))):
        def make(kw=kw):
            return mt.ParallelTempering(
                target, mt.init_det(64, 2, **CPU),
                betas=mt.geometric_betas(4, 0.05), proposal_std=1.5, seed=9,
                **kw, **CPU)
        a, b = make(), make()
        b.state = shard_sampler_state(mesh, b.state)
        spec = dict(positions=str(b.state.positions.placements[0]),
                    raw_logp=str(b.state.raw_logp.placements[0]),
                    swap_accept=str(b.state.swap_accept.placements[0]),
                    parity=type(b.state.parity).__name__)
        full = a.run(16, 8)
        cube, counts = _counted(lambda: b.run(16, 8))
        out[tier] = dict(equal=_equal_rows(full, cube),
                         collectives=_total(counts),
                         spec=spec,
                         swap=bool(torch.equal(a.swap_acceptance,
                                               b.swap_acceptance)))
    return out


def case_sgld(mesh, world):
    data = (torch.linspace(-1.0, 1.0, 512)[:, None] * torch.ones((1, 3)),
            torch.linspace(0.0, 1.0, 512))
    grad_fn = mt.minibatch_grad(
        lambda w: -0.5 * torch.sum(w * w),
        lambda w, b: -0.5 * torch.sum((b[1] - b[0] @ w) ** 2),
        data, batch_size=64, **CPU)
    per_chain = mt.minibatch_grad(
        lambda w: -0.5 * torch.sum(w * w),
        lambda w, b: -0.5 * torch.sum((b[1] - b[0] @ w) ** 2),
        data, batch_size=16, shared_batch=False, **CPU)
    out = {}
    for name, fn in (("shared", grad_fn), ("per_chain", per_chain)):
        def make(fn=fn):
            return mt.SGLD(fn, mt.init_det(64, 3, **CPU),
                           step_size=mt.polynomial_decay(1e-3, 10.0, 0.55),
                           seed=11, **CPU)
        full, cube, counts = _pair(make, mesh, 32, 8)
        out[name] = dict(equal=_equal_rows(full, cube),
                         collectives=_total(counts))
    def sghmc():
        return mt.SGHMC(grad_fn, mt.init_det(64, 3, **CPU), step_size=1e-3,
                        seed=5, **CPU)
    full, cube, counts = _pair(sghmc, mesh, 16, 0)
    out["sghmc"] = dict(equal=_equal_rows(full, cube),
                        collectives=_total(counts))
    return out


def case_slice_elliptical(mesh, world):
    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    lik = Target(
        logp=lambda x: -0.5 * torch.sum((x - 1.0) ** 2),
        logp_batch=lambda xs: -0.5 * torch.sum((xs - 1.0) ** 2, dim=-1))
    out = {}
    for name, make in (
            ("slice", lambda: mt.SliceSampler(
                target, mt.init_det(64, 2, **CPU), width=1.0, seed=5,
                **CPU)),
            ("elliptical", lambda: mt.EllipticalSliceSampler(
                lik, mt.init_det(64, 2, **CPU), prior_scale=2.0, seed=6,
                **CPU))):
        full, cube, counts = _pair(make, mesh, 16, 4)
        out[name] = dict(equal=_equal_rows(full, cube), heavy=_heavy(counts),
                         all_reduce=counts["all_reduce"],
                         scalar=counts["all_reduce_scalar"])
    return out


def case_chees(mesh, world):
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])

    def make():
        return mt.ChEESHMC(target, mt.init_det(128, 2, **CPU),
                           step_size=0.3, max_leapfrog=64, seed=3, **CPU)

    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state)
    wa = a.warmed_up(40)
    wb, warm_counts = _counted(lambda: b.warmed_up(40))
    pa = wa.positions
    pb = wb.positions.full_tensor()
    full = wa.run(16, 0)
    cube, counts = _counted(lambda: wb.run(16, 0))
    return dict(step=(wa.step_size, wb.step_size),
                traj=(wa.traj_len, wb.traj_len),
                positions_equal=bool(torch.equal(pa, pb)),
                mean=(pa.mean(0).tolist(), pb.mean(0).tolist()),
                std=(pa.std(0).tolist(), pb.std(0).tolist()),
                warm_collectives=sum(warm_counts.values()),
                equal=_equal_rows(full, cube),
                collectives=_total(counts))


def case_tuned(mesh, world):
    out = {}
    makers = {
        "hmc": lambda: mt.HMC(rosenbrock_nd(), mt.init_det(32, 3, **CPU),
                              0.05, 5, seed=2, **CPU),
        "mh": lambda: mt.MetropolisHastings(
            gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
            isotropic_gaussian_proposal(1.0), mt.init_det(32, 2, **CPU),
            seed=2, **CPU),
    }
    for name, make in makers.items():
        a, b = make(), make()
        b.state = shard_sampler_state(mesh, b.state)
        ta, tb = a.tuned(30), b.tuned(30)
        full = ta.run(8, 0)
        cube = tb.run(8, 0)
        size = ((ta.step_size, tb.step_size) if name == "hmc"
                else (ta.scale_factor, tb.scale_factor))
        out[name] = dict(size=size, equal=_equal_rows(full, cube),
                         sharded=type(tb.state.positions).__name__)
    # warmed_up: tuned, the metric from every shard's chains, tuned
    a, b = makers["hmc"](), makers["hmc"]()
    b.state = shard_sampler_state(mesh, b.state)
    wa, wb = a.warmed_up(20), b.warmed_up(20)
    out["warmed_up"] = dict(
        size=(wa.step_size, wb.step_size),
        metric=bool(torch.equal(wa.metric.matrix, wb.metric.matrix)),
        equal=_equal_rows(wa.run(8, 0), wb.run(8, 0)))
    return out


def case_ensemble(mesh, world):
    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])

    def make():
        return mt.EnsembleSampler(target, mt.init_det(128, 2, **CPU),
                                  walkers_per_ensemble=32, seed=4, **CPU)

    full, cube, counts = _pair(make, mesh, 20, 10)
    # 96 chains make 48 a rank: not whole ensembles of 32
    bad = mt.EnsembleSampler(target, mt.init_det(96, 2, **CPU),
                             walkers_per_ensemble=32, seed=4, **CPU)
    try:
        bad.state = shard_sampler_state(mesh, bad.state)
        guard = None
    except ValueError as e:
        guard = str(e)
    return dict(equal=_equal_rows(full, cube),
                collectives=_total(counts),
                guard=guard)


def case_ais(mesh, world):
    from mini_mcmc_torch.ops.ais import _ais_result, make_anneal

    target = Target(
        logp=lambda x: -0.5 * torch.sum(x * x),
        logp_batch=lambda xs: -0.5 * torch.sum(xs * xs, dim=-1))
    betas = tuple(float(b) for b in np.linspace(0.0, 1.0, 9)[1:])
    anneal = make_anneal(target, betas, n_mh_steps=2, proposal_std=0.8)
    x0 = torch.randn((512, 2), generator=torch.Generator().manual_seed(0))
    x_full, lw_full = anneal(x0, torch.Generator().manual_seed(1))
    (x_sh, lw_sh), counts = _counted(
        lambda: anneal(shard_chains(mesh, x0),
                       torch.Generator().manual_seed(1)))
    r_full = _ais_result(x_full, lw_full)
    r_sh = _ais_result(x_sh, lw_sh)
    return dict(anneal_collectives=sum(counts.values()),
                weights_equal=_equal_rows(lw_full, lw_sh),
                x_equal=_equal_rows(x_full, x_sh),
                log_z=(float(r_full.log_z), float(r_sh.log_z)),
                ess=(float(r_full.weight_ess), float(r_sh.weight_ess)))


def case_diagnostics(mesh, world):
    mh_kw = dict(seed=3, **CPU)

    def make():
        return mt.MetropolisHastings(
            gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
            isotropic_gaussian_proposal(1.0), mt.init_det(64, 2, **CPU),
            **mh_kw)

    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state)
    full = a.run(400, 100, time_major=True)
    cube = b.run(400, 100, time_major=True)
    r_tm, e_tm = mt.split_rhat_mean_ess(cube, time_major=True)
    cm_full = full.transpose(0, 1).contiguous()
    cube_cm = shard_chains(mesh, cm_full)
    r_cm, e_cm = mt.split_rhat_mean_ess(cube_cm)
    r0, e0 = mt.split_rhat_mean_ess(cm_full)
    rs = mt.run_stats(cube, time_major=True)
    rs0 = mt.run_stats(full, time_major=True)
    sm = mt.summary(cube, time_major=True)
    sm0 = mt.summary(full, time_major=True)
    return dict(cube=full.numpy(), rhat=(r0.numpy(), r_tm.numpy(),
                                        r_cm.numpy()),
                ess=(e0.numpy(), e_tm.numpy(), e_cm.numpy()),
                run_stats=(rs.rhat.mean, rs0.rhat.mean, rs.ess.mean,
                           rs0.ess.mean),
                summary=(sm.mean.numpy(), sm0.mean.numpy(),
                         sm.ess_bulk.numpy(), sm0.ess_bulk.numpy()))


def case_progress_stream(mesh, world):
    import io

    def make():
        return mt.HMC(rosenbrock_nd(), mt.init_det(16, 3, **CPU), 0.02, 5,
                      use_pallas="full", steps_per_call=4, seed=4, **CPU)

    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state)
    full = a.run(16, 8)
    cube, stats = b.run_progress(16, 8, stream=io.StringIO())
    a2, b2 = make(), make()
    b2.state = shard_sampler_state(mesh, b2.state)
    ra = mt.stream_run(a2, 16, 4, n_discard=8)
    rb = mt.stream_run(b2, 16, 4, n_discard=8)
    return dict(progress_equal=_equal_rows(full, cube),
                rhat=(float(stats.rhat.mean),
                      float(mt.run_stats(full).rhat.mean)),
                stream_rhat=(ra.rhat.tolist(), rb.rhat.tolist()),
                stream_p=(float(ra.p_accept), float(rb.p_accept)))


def _dpg_problem(n=64, d=3):
    g = np.random.default_rng(0)
    x = g.standard_normal((n, d)).astype(np.float32)
    y = g.standard_normal(n).astype(np.float32)

    def log_prior(w):
        return -0.5 * torch.sum(w * w)

    def log_like(w, batch):
        xb, yb = batch
        r = yb - xb @ w
        return -0.5 * torch.sum(r * r)

    return log_prior, log_like, (torch.from_numpy(x), torch.from_numpy(y))


def case_data_parallel(mesh, world):
    dmesh = data_mesh(device="cpu")
    log_prior, log_like, data = _dpg_problem()
    gf = mt.data_parallel_grad(log_prior, log_like, data, batch_size=64,
                               mesh=dmesh)
    pos = torch.ones((2, 3))
    gen = torch.Generator().manual_seed(7)
    collectives.reset_counts()
    total = torch.zeros((2, 3), dtype=torch.float64)
    n_keys = 768
    for _ in range(n_keys):
        total += gf(pos, gen).double()
    one_call = collectives.counts()
    avg = (total / n_keys).numpy()
    gf32 = mt.data_parallel_grad(log_prior, log_like, data, batch_size=32,
                                 mesh=dmesh)
    a = gf32(torch.ones((4, 3)), torch.Generator().manual_seed(3))
    b = gf32(torch.ones((4, 3)), torch.Generator().manual_seed(3))
    c = gf32(torch.ones((4, 3)), torch.Generator().manual_seed(4))
    # a pre-sharded leaf in the required layout
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x_good = distribute_tensor(data[0], dmesh, [Shard(0)])
    y_good = distribute_tensor(data[1], dmesh, [Shard(0)])
    good = mt.data_parallel_grad(log_prior, log_like, (x_good, y_good),
                                 batch_size=64, mesh=dmesh)
    same = mt.data_parallel_grad(log_prior, log_like, data, batch_size=64,
                                 mesh=dmesh)
    pre_equal = bool(torch.equal(
        good(pos, torch.Generator().manual_seed(9)),
        same(pos, torch.Generator().manual_seed(9))))
    errors = {}
    for name, bad in (("replicated", distribute_tensor(
            data[0], dmesh, [Replicate()])),
                      ("dim1", distribute_tensor(
            torch.cat([data[0]] * 2, dim=1)[:, :4].contiguous(), dmesh,
            [Shard(1)])),
                      ("other_mesh", distribute_tensor(
            data[0], chain_mesh(device="cpu"), [Shard(0)]))):
        try:
            mt.data_parallel_grad(log_prior, log_like, (bad, data[1]),
                                  batch_size=64, mesh=dmesh)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    guards = {}
    for name, kw in (("rows", dict(data=(data[0][:63], data[1][:63]),
                                   batch_size=32)),
                     ("batch", dict(data=data, batch_size=13))):
        try:
            mt.data_parallel_grad(log_prior, log_like, mesh=dmesh, **kw)
            guards[name] = None
        except ValueError as e:
            guards[name] = str(e)
    return dict(avg=avg, counts_per_call={k: v / n_keys
                                          for k, v in one_call.items()},
                deterministic=bool(torch.equal(a, b)),
                differs=bool((a != c).any()), pre_equal=pre_equal,
                errors=errors, guards=guards)


def case_sgld_data_parallel(mesh, world):
    n, d, tau, s_noise = 2048, 2, 2.0, 0.5
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    w_true = np.asarray([1.0, -0.5], np.float32)
    y = (x @ w_true + s_noise * rng.standard_normal(n)).astype(np.float32)
    prec = x.T @ x / s_noise**2 + np.eye(d) / tau**2
    post_cov = np.linalg.inv(prec)
    post_mean = post_cov @ (x.T @ y) / s_noise**2
    gf = mt.data_parallel_grad(
        lambda w: -0.5 * torch.sum(w * w) / tau**2,
        lambda w, b: -0.5 * torch.sum((b[1] - b[0] @ w) ** 2) / s_noise**2,
        (torch.as_tensor(x, dtype=torch.float32),
         torch.as_tensor(y, dtype=torch.float32)), batch_size=512,
        mesh=data_mesh(device="cpu"))
    sg = mt.SGLD(gf, mt.init_det(256, d, **CPU), step_size=5e-5, seed=13,
                 **CPU)
    sample, counts = _counted(lambda: sg.run(1500, 1500))
    sample = sample.numpy().reshape(-1, d)
    return dict(mean=sample.mean(0), var=sample.var(0), post_mean=post_mean,
                post_var=np.diag(post_cov), counts=counts)


def case_guards(mesh, world):
    hmc = mt.HMC(mt.standard_normal(), mt.init_det(16, 4, **CPU), 0.1, 3,
                 **CPU)
    out = {}
    for name, fn in (
            ("chainless", lambda: shard_sampler_state(
                data_mesh(device="cpu"), hmc.state)),
            ("state_dim", lambda: shard_sampler_state(
                mesh, hmc.state, shard_state_dim=True)),
            ("indivisible", lambda: shard_sampler_state(
                mesh, mt.HMC(mt.standard_normal(),
                             mt.init_det(15, 4, **CPU), 0.1, 3,
                             **CPU).state))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_checkpoint(mesh, world):
    from mini_mcmc_torch.checkpoint import (
        load_checkpoint,
        restore_sampler,
        save_sampler,
    )

    path = os.path.join(tempfile.gettempdir(),
                        f"mm_torch_parallel_{os.getppid()}", "nuts")

    def make(seed=7):
        return mt.NUTS(diffable_gaussian2d([0.0, 1.0],
                                           [[4.0, 2.0], [2.0, 3.0]]),
                       mt.init_det(16, 2, **CPU), 0.8, seed=seed,
                       use_pallas="full", max_depth=6, **CPU)

    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state)
    a.run(4, 4)
    b.run(4, 4)
    save_sampler(path, b)
    state, _ = load_checkpoint(path, **CPU)
    same = all(torch.equal(x, y) for x, y in zip(state, a.state)
               if isinstance(x, torch.Tensor))
    c = restore_sampler(path, make(seed=99), mesh=mesh)
    full = a.run(6, 0)
    cube = c.run(6, 0)
    return dict(file_equal=same, continues=_equal_rows(full, cube),
                sharded=type(c.state.positions).__name__)


def case_examples(mesh, world):
    import contextlib
    import io

    from mini_mcmc_torch.examples import (
        poisson_mh,
        sgld_data_parallel,
        sharded_chains,
    )

    out = {}
    for name, mod in (("poisson_mh", poisson_mh),
                      ("sharded_chains", sharded_chains),
                      ("sgld_data_parallel", sgld_data_parallel)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(device="cpu")
        out[name] = buf.getvalue()
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


#: the cases of the second two-rank group, the data mesh, and of the
#: third, the mesh examples: each about a third of the cases' time
DATA_CASES = ("data_parallel", "sgld_data_parallel")
EXAMPLE_CASES = ("examples",)


def _run(names, world):
    mesh = chain_mesh(device="cpu")
    out = {}
    for name in names:
        try:
            out[name] = ("ok", CASES[name](mesh, world))
        except Exception:  # noqa: BLE001 - reported per case
            out[name] = ("error", traceback.format_exc())
    return out


def two_ranks(rank, world):
    """The chain cases on this rank: ``{case: ("ok", result) | ("error",
    traceback)}``."""
    return _run([n for n in CASES
                 if n not in DATA_CASES + EXAMPLE_CASES], world)


def two_ranks_data(rank, world):
    """The data-mesh cases on this rank."""
    return _run(DATA_CASES, world)


def two_ranks_examples(rank, world):
    """The three mesh examples' ``main(device="cpu")`` on this rank."""
    return _run(EXAMPLE_CASES, world)


def four_ranks(rank, world):
    return _run(("layout", "hmc", "nuts", "slice_elliptical"), world)
