"""Discrete-state MH: Poisson(4) with a +-1 random-walk proposal and a text
histogram, at 65,536 int32 chains sharded over a chain mesh.

Counterpart of ``examples/poisson_mh.py``. On CUDA the chains run through
Kernel 5's int32 Poisson instance (``use_pallas="full"``, one launch a
100-step block), each shard drawing at its chains' global places; on the
CPU the plain tier, as the JAX example runs.
"""

import numpy as np
import torch
from scipy.stats import poisson

from .. import MetropolisHastings
from ..models import poisson_target, random_walk_int_proposal
from ..parallel import chain_mesh, shard_sampler_state

N_CHAINS = 65536
LAMBDA = 4.0
#: Kernel 5's steps a launch on CUDA: run(200, 100) is three blocks
BLOCK = 100


def mh_tier(device) -> dict:
    """The MH tier the example takes on ``device``: Kernel 5 on CUDA, the
    plain tier on the CPU."""
    return ({"use_pallas": "full", "steps_per_call": BLOCK}
            if torch.device(device).type == "cuda" else {})


def main(device="cuda"):
    # the mesh first: on CUDA without a GPU it raises, naming device='cpu'
    mesh = chain_mesh(device=device)
    target = poisson_target(LAMBDA)
    proposal = random_walk_int_proposal()
    init = torch.zeros((N_CHAINS, 1), dtype=torch.int32)
    mh = MetropolisHastings(target, proposal, init, device=device,
                            **mh_tier(device)).seed(42)

    # Shard the chains axis over every rank of the mesh (one on a single
    # GPU; two in the CPU tests' gloo group).
    mh.state = shard_sampler_state(mesh, mh.state)

    sample = mh.run(200, 100)
    ks = sample.full_tensor().cpu().numpy().ravel()

    print(f"{N_CHAINS} chains x {sample.shape[1]} draws over "
          f"{mesh.size()} device(s)")
    for k in range(11):
        freq = float(np.mean(ks == k))
        pmf = poisson.pmf(k, LAMBDA)
        bar = "#" * int(freq * 200)
        print(f"k={k:2d} freq={freq:.4f} pmf={pmf:.4f} {bar}")
        assert abs(freq - pmf) < 0.05


if __name__ == "__main__":
    main()
