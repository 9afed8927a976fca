"""Device mesh and chain sharding (counterpart of
``mini_mcmc_tpu/parallel/mesh.py``).

The JAX package lays chains out over a 1-D ``jax.sharding.Mesh`` and lets
XLA's SPMD partitioner run the same program on each shard. Here a mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
with the JAX package's dimension names, one rank a device, and a sharded
sampler state is the state's own NamedTuple whose tensor leaves are
:class:`~torch.distributed.tensor.DTensor` s, placed ``Shard(axis)`` over
the ``"chains"`` dimension or ``Replicate()``: the counterpart of a
``NamedSharding``. A sampler given such a state runs each rank's own
chains (``samplers.py``); chains never communicate while they sample, and
only the loop exits, the adaptation's cross-chain means and the
diagnostics cross ranks (``collectives.py``).

A mesh lives on CUDA unless the caller asks for the CPU (``device="cpu"``:
gloo collectives, as the tests run them). With no process group yet,
:func:`chain_mesh` and :func:`data_mesh` start a one-rank group of their
own (NCCL on CUDA, gloo on the CPU), needing no environment variables, as
a one-device JAX mesh needs none; a job of several ranks starts its group
first (``multihost.initialize``). The state dimension is not split here:
``shard_state_dim=True`` keeps the JAX guard, and a mesh with a
``"state"`` axis is not built (``chain_state_mesh``, ROADMAP item 12b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.init import resolve_device
from .collectives import ChainGroup

CHAIN_AXIS = "chains"
DATA_AXIS = "data"
STATE_AXIS = "state"


def _dtensor():
    """``(DTensor, Shard, Replicate)``, from the public module where this
    PyTorch has one."""
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:  # PyTorch before 2.4
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Shard, Replicate


def _start_group(device: torch.device) -> None:
    """A one-rank process group (NCCL on CUDA, gloo on the CPU) on an
    in-process store, unless one is running."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(axis: str, n_devices: Optional[int], devices,
          device) -> "torch.distributed.device_mesh.DeviceMesh":
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    _start_group(dev)
    world = dist.get_world_size()
    if devices is None:
        devices = list(range(world if n_devices is None else n_devices))
    ranks = [int(r) for r in devices]
    if not ranks or min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"a mesh takes ranks of the process group, 0 to "
                         f"{world - 1}; got {ranks}")
    if dev.type == "cuda" and world > 1:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, ranks, mesh_dim_names=(axis,))


def chain_mesh(n_devices: Optional[int] = None, devices=None, *,
               device="cuda"):
    """1-D mesh over the ``"chains"`` axis.

    Args:
        n_devices: ranks to use, the first ``n_devices`` (default: all of
            the process group).
        devices: explicit list of ranks (overrides ``n_devices``).
        device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    """
    return _mesh(CHAIN_AXIS, n_devices, devices, device)


def data_mesh(n_devices: Optional[int] = None, devices=None, *,
              device="cuda"):
    """1-D mesh over a ``"data"`` axis, for dataset sharding with
    :func:`~mini_mcmc_torch.data_parallel_grad` (chains stay replicated
    over this axis; the dataset's rows split across it)."""
    return _mesh(DATA_AXIS, n_devices, devices, device)


class Sharding(NamedTuple):
    """Where a tensor lies on a mesh: the counterpart of a
    ``NamedSharding``, one placement per mesh dimension."""

    mesh: object
    placements: tuple


def _chain_dim(mesh) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if CHAIN_AXIS not in names:
        raise ValueError(
            f"shard_sampler_state needs a mesh with a '{CHAIN_AXIS}' axis "
            f"(chain_mesh); got axes {names}")
    return names.index(CHAIN_AXIS)


def _placements(mesh, axis: Optional[int]):
    """One placement a mesh dimension: ``Shard(axis)`` on the chains
    dimension (``None``: replicated), replicated on the others."""
    _, shard, replicate = _dtensor()
    out = [replicate()] * mesh.ndim
    if axis is not None:
        out[_chain_dim(mesh)] = shard(axis)
    return tuple(out)


def chain_sharding(mesh, ndim: int = 2) -> Sharding:
    """Sharding for a ``[chains, ...]`` tensor: chains split over the
    mesh, trailing axes replicated."""
    if ndim < 1:
        raise ValueError(f"a chain-sharded tensor has ndim >= 1; got {ndim}")
    return Sharding(mesh, _placements(mesh, 0))


def replicated_sharding(mesh) -> Sharding:
    return Sharding(mesh, _placements(mesh, None))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(x: torch.Tensor, mesh, axis: Optional[int]):
    """``x`` (the full tensor, the same on every rank) as a DTensor with
    its axis ``axis`` split over the mesh (``None``: replicated). Each rank
    keeps its own rows; nothing is communicated."""
    dtensor, _, _ = _dtensor()
    if isinstance(x, dtensor):
        x = x.full_tensor()
    x = x.to(_mesh_device(mesh))
    placements = _placements(mesh, axis)
    if axis is not None:
        dim = _chain_dim(mesh)
        size, rank = mesh.size(dim), mesh.get_local_rank(dim)
        n = x.shape[axis]
        if n % size:
            raise ValueError(
                f"{n} chains do not divide over the mesh's {size} "
                f"'{mesh.mesh_dim_names[dim]}' shards; use a chain count "
                f"that is a multiple of {size}")
        x = x.narrow(axis, rank * (n // size), n // size).contiguous()
    return dtensor.from_local(x, mesh, placements, run_check=False)


def shard_chains(mesh, array: torch.Tensor):
    """Place a ``[chains, ...]`` tensor with its leading axis sharded."""
    return _place(array, mesh, 0)


def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def shard_sampler_state(mesh, state, *, shard_state_dim: bool = False):
    """Shard every tensor leaf of a sampler state along its chains axis;
    0-d tensors are replicated and host values (ints) stay as they are.

    By default the chains axis is the leading axis of every leaf. A state
    type may override per field with a ``CHAIN_AXIS_INDEX`` class
    attribute mapping field name -> axis index or ``None`` (replicate),
    as the tempering state does (``ops/tempering.py``). A chain count that
    does not divide by the mesh raises ``ValueError``.

    ``shard_state_dim=True`` needs a mesh with a ``"state"`` axis, which
    this package does not build yet (ROADMAP item 12b): the guard raises
    the JAX package's ``ValueError`` without one.
    """
    _chain_dim(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if shard_state_dim and STATE_AXIS not in names:
        raise ValueError(
            f"shard_state_dim=True needs a mesh with a '{STATE_AXIS}' axis "
            f"(see chain_state_mesh); got axes {names}")
    if shard_state_dim:
        raise NotImplementedError(
            "splitting the state dimension over a 'state' axis is not "
            "ported yet (ROADMAP item 12b)")

    def place(x, axis):
        if _is_state(x):
            return shard_sampler_state(mesh, x)
        if not isinstance(x, torch.Tensor):
            return x
        return _place(x, mesh, axis if x.dim() >= 1 else None)

    if not _is_state(state):
        return place(state, 0)
    axis_of = getattr(type(state), "CHAIN_AXIS_INDEX", None) or {}
    return type(state)(*[place(getattr(state, name), axis_of.get(name, 0))
                         for name in state._fields])


def from_local_state(mesh, state):
    """A state of this rank's own chains (every rank's the same type, its
    chain axes per ``CHAIN_AXIS_INDEX``) as the sharded global state: the
    counterpart of ``jax.make_array_from_callback``."""
    if not _is_state(state):
        return _wrap(state, 0 if state.dim() >= 1 else None, mesh)
    axis_of = getattr(type(state), "CHAIN_AXIS_INDEX", None) or {}

    def place(x, axis):
        if _is_state(x):
            return from_local_state(mesh, x)
        if not isinstance(x, torch.Tensor):
            return x
        return _wrap(x, axis if x.dim() >= 1 else None, mesh)

    return type(state)(*[place(getattr(state, name), axis_of.get(name, 0))
                         for name in state._fields])


class StateLayout(NamedTuple):
    """How a sharded state lies on its mesh: ``axes`` mirrors the state,
    each tensor leaf's chain axis (``None``: replicated; ``False``: a leaf
    that was not a DTensor), and ``chains`` is this rank's
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`."""

    mesh: object
    axes: object
    chains: ChainGroup

    def wrap(self, state):
        """The rank's local ``state`` as DTensors again."""
        return _wrap(state, self.axes, self.mesh)

    def wrap_chains(self, x: torch.Tensor, axis: int = 0):
        """A local tensor whose axis ``axis`` holds this shard's chains
        (a sample cube, a per-chain read-out) as a DTensor."""
        dtensor, _, _ = _dtensor()
        return dtensor.from_local(x, self.mesh, _placements(self.mesh, axis),
                                  run_check=False)


def _wrap(x, axes, mesh):
    if _is_state(x):
        return type(x)(*[_wrap(v, a, mesh) for v, a in zip(x, axes)])
    if axes is False or not isinstance(x, torch.Tensor):
        return x
    dtensor, _, _ = _dtensor()
    return dtensor.from_local(x, mesh, _placements(mesh, axes),
                              run_check=False)


def local_state(state):
    """``(local, layout)``: the rank's local tensors of a state whose
    leaves are DTensors on a chain mesh and its :class:`StateLayout`, or
    ``(state, None)`` for a state with no DTensor leaf."""
    dtensor, shard, _ = _dtensor()
    found = {}

    def unwrap(x):
        if _is_state(x):
            pairs = [unwrap(v) for v in x]
            return type(x)(*[p[0] for p in pairs]), tuple(p[1] for p in pairs)
        if not isinstance(x, dtensor):
            return x, False
        mesh = found.setdefault("mesh", x.device_mesh)
        if mesh is not x.device_mesh and mesh != x.device_mesh:
            raise ValueError("a sharded state's leaves lie on one mesh")
        p = x.placements[_chain_dim(mesh)]
        axis = p.dim if isinstance(p, shard) else None
        if axis is not None:
            n = found.setdefault("n_chains", x.shape[axis])
            if n != x.shape[axis]:
                raise ValueError(f"a sharded state's leaves hold {n} and "
                                 f"{x.shape[axis]} chains")
        return x.to_local(), axis

    local, axes = unwrap(state)
    if "mesh" not in found:
        return state, None
    mesh = found["mesh"]
    dim = _chain_dim(mesh)
    size, rank = mesh.size(dim), mesh.get_local_rank(dim)
    n = found.get("n_chains", 0)
    chains = ChainGroup(chain0=rank * (n // size), n_chains=n,
                        group=mesh.get_group(dim), size=size, rank=rank)
    return local, StateLayout(mesh, axes, chains)
