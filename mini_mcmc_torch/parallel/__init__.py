"""Chain, state-dimension and data parallelism over a ``torch.distributed``
mesh (counterpart of ``mini_mcmc_tpu.parallel``)."""

from . import collectives, multihost
from .mesh import (
    chain_mesh,
    chain_sharding,
    chain_state_mesh,
    data_mesh,
    replicated_sharding,
    shard_chains,
    shard_sampler_state,
)

__all__ = [
    "chain_mesh",
    "chain_sharding",
    "chain_state_mesh",
    "data_mesh",
    "replicated_sharding",
    "shard_chains",
    "shard_sampler_state",
]
