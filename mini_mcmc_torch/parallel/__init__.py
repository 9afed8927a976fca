"""Chain and data parallelism over a ``torch.distributed`` mesh
(counterpart of ``mini_mcmc_tpu.parallel``; ``chain_state_mesh``, the state
dimension split over a ``"state"`` axis, is not ported yet)."""

from . import collectives, multihost
from .mesh import (
    chain_mesh,
    chain_sharding,
    data_mesh,
    replicated_sharding,
    shard_chains,
    shard_sampler_state,
)

__all__ = [
    "chain_mesh",
    "chain_sharding",
    "data_mesh",
    "replicated_sharding",
    "shard_chains",
    "shard_sampler_state",
]
