"""Several processes, one chain mesh (counterpart of
``mini_mcmc_tpu/parallel/multihost.py``).

Chains stay pure data parallelism across processes too: a rank advances
its own chains, and only the loop exits, the adaptation's cross-chain
means and the diagnostics cross ranks (``collectives.py``). Nothing on a
machine tells a process of its peers, so the caller names the rendezvous.

Usage on each process of a job:

    from mini_mcmc_torch.parallel import multihost
    multihost.initialize(init_method="tcp://HOST:PORT", world_size=N,
                         rank=RANK, backend="nccl")   # gloo on the CPU
    mesh = multihost.global_chain_mesh()
    state = multihost.host_local_state(mesh, init_fn, n_chains, dim, seed)
    sampler.state = state          # then run as usual
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import CHAIN_AXIS, _mesh_device, chain_mesh, from_local_state


def initialize(**kwargs) -> None:
    """Start the process group (idempotent): ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``backend``,
    ``init_method``, ``world_size``, ``rank``, ...). A running group is
    kept; real failures (an unreachable rendezvous, a bad rank)
    propagate."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError) as e:
        if "already" not in str(e).lower():
            raise


def global_chain_mesh(*, device="cuda"):
    """1-D chains mesh over every rank of the job."""
    return chain_mesh(device=device)


def host_local_state(mesh, init_fn: Callable, n_chains: int, dim: int,
                     key: int, dtype=torch.float32):
    """A sharded initial sampler state of which each rank builds only its
    own chains.

    ``n_chains`` is the global chain count and ``key`` a 64-bit seed.
    Chain ``c``'s position is the standard normal drawn by place from
    Philox at ``(c, 0)`` under ``key`` (``rng.paired_normals``), so the
    result is the one a one-rank call with the same key gives, whatever
    the mesh (the JAX package folds the global chain index into its key).
    ``init_fn`` maps the rank's ``[C_local, dim]`` rows to a state.
    """
    from ..ops.kernels import rng

    dim_i = mesh.mesh_dim_names.index(CHAIN_AXIS)
    size, rank = mesh.size(dim_i), mesh.get_local_rank(dim_i)
    if n_chains % size:
        raise ValueError(
            f"{n_chains} chains do not divide over the mesh's {size} "
            f"'{CHAIN_AXIS}' shards; use a chain count that is a multiple "
            f"of {size}")
    local = n_chains // size
    rows = rng.paired_normals(local, dim, 0, key, _mesh_device(mesh),
                              chain0=rank * local).to(dtype)
    return from_local_state(mesh, init_fn(rows))
