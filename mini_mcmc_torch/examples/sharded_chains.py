"""Chain sharding: the pure-data-parallel scaling story.

Counterpart of ``examples/sharded_chains.py``. Chains shard over a 1-D
chain mesh (``mini_mcmc_torch.parallel``); sampling makes no collective,
each rank advancing its own chains with the draws of their global places
(``parallel/collectives.py`` counts what crosses ranks), while the R-hat
and ESS diagnostics reduce across the mesh.
"""

from .. import HMC, init_det, run_stats
from ..models import rosenbrock_nd
from ..parallel import chain_mesh, shard_sampler_state


def main(device="cuda"):
    mesh = chain_mesh(device=device)
    n_devices = mesh.size()
    n_chains = 512 * n_devices  # scale the batch with the mesh

    sampler = HMC(rosenbrock_nd(), init_det(n_chains, 3, device=device),
                  step_size=0.02, n_leapfrog=16, device=device).seed(7)
    sampler.state = shard_sampler_state(mesh, sampler.state)

    sample = sampler.run(256, 64)
    shards = sample.device_mesh.size()
    print(f"{n_chains} chains sharded over {shards} device(s); "
          f"cube {tuple(sample.shape)} stays sharded on the chains axis")
    print(run_stats(sample))  # cross-chain reductions cross the mesh


if __name__ == "__main__":
    main()
