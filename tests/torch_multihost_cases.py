"""The rank side of ``test_torch_multihost.py``, the counterpart of
``tests/multihost_worker.py``: two processes start their group through
``parallel.multihost.initialize``, build a global chain mesh, a sharded
initial state of which each builds its own rows, run a sharded MH chain,
reduce the tracker's R-hat across processes and save and restore a sharded
checkpoint. Every result is held to a one-process replay on the rank.
Imports torch and the port only.
"""

import os
import tempfile

import torch

from mini_mcmc_torch import MetropolisHastings
from mini_mcmc_torch.checkpoint import (
    load_checkpoint,
    restore_sampler,
    save_checkpoint,
)
from mini_mcmc_torch.models import gaussian2d, isotropic_gaussian_proposal
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.mh import mh_kernel
from mini_mcmc_torch.parallel import collectives, multihost
from mini_mcmc_torch.parallel.mesh import local_state
from mini_mcmc_torch.runner import StepKey, make_simple_runner
from mini_mcmc_torch.stats import tracker_init, tracker_max_rhat

N_CHAINS, DIM, N_STEPS, KEY = 16, 2, 50, 5


def run(rank, world, init_method):
    import torch.distributed as dist

    multihost.initialize(backend="gloo", init_method=init_method,
                         world_size=world, rank=rank)
    multihost.initialize(backend="gloo", init_method=init_method,
                         world_size=world, rank=rank)  # a no-op now
    out = dict(world=dist.get_world_size(), rank=dist.get_rank())
    mesh = multihost.global_chain_mesh(device="cpu")
    out["mesh_size"] = mesh.size()

    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    init_fn, step_fn = mh_kernel(target, proposal)
    state = multihost.host_local_state(mesh, init_fn, N_CHAINS, DIM, KEY)
    local, layout = local_state(state)
    one_rank = rng.paired_normals(N_CHAINS, DIM, 0, KEY)
    c = local.positions.shape[0]
    mine = slice(layout.chains.chain0, layout.chains.chain0 + c)
    out["local_rows"] = c
    out["init_equal"] = bool(torch.equal(local.positions, one_rank[mine]))

    # the runner on the rank's rows, drawing at their global places, with
    # the streaming tracker; its R-hat reduces across processes
    runner = make_simple_runner(step_fn)
    key = StepKey(seed=11, step=0, generator=torch.Generator(),
                  chains=layout.chains)
    end, _, tracker = runner(local, key, N_STEPS, 0,
                             tracker=tracker_init(c, DIM, device="cpu"))
    max_rhat = float(tracker_max_rhat(tracker, layout.chains))
    ref_key = StepKey(seed=11, step=0, generator=torch.Generator())
    ref, _, ref_tracker = runner(init_fn(one_rank), ref_key, N_STEPS, 0,
                                 tracker=tracker_init(N_CHAINS, DIM,
                                                      device="cpu"))
    out["run_equal"] = bool(torch.equal(end.positions, ref.positions[mine]))
    out["max_rhat"] = (max_rhat, float(tracker_max_rhat(ref_tracker)))

    # a sharded sampler's run against its unsharded replay
    def sampler():
        return MetropolisHastings(target, proposal, one_rank, seed=3,
                                  device="cpu")

    a, b = sampler(), sampler()
    b.state = state
    full = a.run(N_STEPS, 10)
    cube = b.run(N_STEPS, 10)
    out["sampler_equal"] = bool(torch.equal(cube.to_local(), full[mine]))

    # save is a collective: both ranks call it, rank 0 writes, a barrier
    path = os.path.join(tempfile.gettempdir(),
                        f"mm_torch_multihost_{os.getppid()}", "state")
    collectives.reset_counts()
    save_checkpoint(path, b.state, b._gen)
    out["save_counts"] = collectives.counts()
    restored, _ = load_checkpoint(path, device="cpu")
    out["restored_equal"] = bool(torch.equal(
        restored.positions, b.state.positions.full_tensor()))
    c2 = restore_sampler(path, sampler(), mesh=mesh)
    out["restore_continues"] = bool(torch.equal(
        c2.run(8, 0).to_local(), b.run(8, 0).to_local()))
    return out
