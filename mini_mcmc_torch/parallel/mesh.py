"""Device mesh, chain and state sharding (counterpart of
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
:func:`chain_mesh`, :func:`data_mesh` and :func:`chain_state_mesh` start a
one-rank group of their own (NCCL on CUDA, gloo on the CPU), needing no
environment variables, as a one-device JAX mesh needs none; a job of
several ranks starts its group first (``multihost.initialize``).

:func:`chain_state_mesh` adds a ``"state"`` axis, and
``shard_sampler_state(..., shard_state_dim=True)`` splits the state
dimension over it: each rank keeps a D-slice of its chains. Where the JAX
package lets GSPMD partition the density, the lockstep HMC, MALA, NUTS and
MH steps run the target on a ``DTensor`` view of the slice
(:class:`SliceTarget`, MH's proposal density :class:`SliceProposal`) and
sum their energies over the axis (``ops/hmc.py``, ``ops/nuts.py``,
``ops/mh.py``), SGLD and SGHMC take the gradient on that view
(``ops/sgmcmc.py``), and the separable tier runs Kernel 7 at the slice's
first coordinate (``ops/kernels/hmc_sep.py``). Every other sampler and
fused tier refuses such a state (``samplers.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.init import resolve_device
from .collectives import ChainGroup, StateGroup

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


def _group(device) -> tuple:
    """``(device, world size)`` of the running process group, started if
    need be; a multi-rank CUDA group puts each rank on its own card."""
    import torch.distributed as dist

    dev = resolve_device(device)
    _start_group(dev)
    world = dist.get_world_size()
    if dev.type == "cuda" and world > 1:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dev, world


def _check_ranks(ranks, world: int) -> None:
    if not ranks or min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"a mesh takes ranks of the process group, 0 to "
                         f"{world - 1}; got {ranks}")


def _mesh(axis: str, n_devices: Optional[int], devices,
          device) -> "torch.distributed.device_mesh.DeviceMesh":
    from torch.distributed.device_mesh import DeviceMesh

    dev, world = _group(device)
    if devices is None:
        devices = list(range(world if n_devices is None else n_devices))
    ranks = [int(r) for r in devices]
    _check_ranks(ranks, world)
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


def chain_state_mesh(n_chain_shards: int, n_state_shards: int, devices=None,
                     *, device="cuda"):
    """2-D ``("chains", "state")`` mesh for states too large for one
    card: chains split over the first axis, the state dimension over the
    second (``mini_mcmc_tpu/parallel/mesh.py:chain_state_mesh``). Rank
    ``r`` of ``devices`` (default: the process group's ranks) sits at
    chain shard ``r // n_state_shards`` and state shard ``r %
    n_state_shards``. With ``n_chain_shards=1`` this is pure
    state-dimension sharding.

    Under this mesh, :func:`shard_sampler_state` with
    ``shard_state_dim=True`` lays every ``[C, D]`` leaf out as
    ``(Shard(0), Shard(1))``. A lockstep HMC or MALA step then
    communicates only its energy sums across the state axis (all-reduces;
    an elementwise density's leapfrog never communicates), and the
    separable tier one all-reduce a step.

    Raises ``ValueError`` with fewer ranks than ``n_chain_shards *
    n_state_shards``. ``device``: ``"cuda"`` (default; raises without a
    GPU) or ``"cpu"``.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev, world = _group(device)
    if devices is None:
        devices = list(range(world))
    n = n_chain_shards * n_state_shards
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for a {n_chain_shards}x{n_state_shards} "
            f"mesh; have {len(devices)}")
    ranks = [int(r) for r in devices[:n]]
    _check_ranks(ranks, world)
    grid = torch.tensor(ranks).reshape(n_chain_shards, n_state_shards)
    return DeviceMesh(dev.type, grid, mesh_dim_names=(CHAIN_AXIS, STATE_AXIS))


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


def _state_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(STATE_AXIS) if STATE_AXIS in names else None


def _placements(mesh, axis: Optional[int], state_axis: Optional[int] = None):
    """One placement a mesh dimension: ``Shard(axis)`` on the chains
    dimension (``None``: replicated), ``Shard(state_axis)`` on the state
    dimension (``None``: replicated), replicated on the others."""
    _, shard, replicate = _dtensor()
    out = [replicate()] * mesh.ndim
    if axis is not None:
        out[_chain_dim(mesh)] = shard(axis)
    if state_axis is not None:
        out[_state_dim(mesh)] = shard(state_axis)
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


def _place(x: torch.Tensor, mesh, axis: Optional[int],
           state_axis: Optional[int] = None):
    """``x`` (the full tensor, the same on every rank) as a DTensor with
    its axis ``axis`` split over the chains dimension and ``state_axis``
    over the state dimension (``None``: replicated). Each rank keeps its
    own block; nothing is communicated."""
    dtensor, _, _ = _dtensor()
    if isinstance(x, dtensor):
        x = x.full_tensor()
    x = x.to(_mesh_device(mesh))
    placements = _placements(mesh, axis, state_axis)
    for ax, dim, what in ((axis, _chain_dim(mesh), "chains"),
                          (state_axis, _state_dim(mesh), "coordinates")):
        if ax is None:
            continue
        size, rank = mesh.size(dim), mesh.get_local_rank(dim)
        n = x.shape[ax]
        if n % size:
            raise ValueError(
                f"{n} {what} do not divide over the mesh's {size} "
                f"'{mesh.mesh_dim_names[dim]}' shards; use a count of "
                f"{what} that is a multiple of {size}")
        x = x.narrow(ax, rank * (n // size), n // size)
    return dtensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False)


def shard_chains(mesh, array: torch.Tensor):
    """Place a ``[chains, ...]`` tensor with its leading axis sharded."""
    return _place(array, mesh, 0)


def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _state_axis_of(state, name: str, x, chain_axis) -> Optional[int]:
    """The axis of field ``name`` (``x``) that a state split puts on the
    ``"state"`` axis: the state type's ``STATE_AXIS_INDEX`` entry where it
    has one (a field it leaves out stays whole), else the JAX rule, the
    last axis of a chain-sharded leaf of rank >= 2 that is not its chain
    axis."""
    marks = getattr(type(state), "STATE_AXIS_INDEX", None)
    if chain_axis is None or not isinstance(x, torch.Tensor):
        return None
    if marks is not None:
        return marks.get(name)
    last = x.dim() - 1
    return last if x.dim() >= 2 and last != chain_axis else None


def shard_sampler_state(mesh, state, *, shard_state_dim: bool = False):
    """Shard every tensor leaf of a sampler state along its chains axis;
    0-d tensors are replicated and host values (ints) stay as they are.

    By default the chains axis is the leading axis of every leaf. A state
    type may override per field with a ``CHAIN_AXIS_INDEX`` class
    attribute mapping field name -> axis index or ``None`` (replicate),
    as the tempering state does (``ops/tempering.py``). A chain count that
    does not divide by the mesh raises ``ValueError``.

    ``shard_state_dim=True`` (a mesh with a ``"state"`` axis,
    :func:`chain_state_mesh`) also splits the state dimension of every
    chain-sharded leaf over that axis. A state type names that axis per
    field with a ``STATE_AXIS_INDEX`` class attribute (field -> axis;
    a field it leaves out, or marks ``None``, stays whole: a table whose
    last axis is not D); without one, the last axis of every leaf of rank
    >= 2 whose last axis is not its chain axis, as the JAX package splits
    it. Fields replicated by ``CHAIN_AXIS_INDEX`` stay replicated. A D
    that does not divide by the axis raises ``ValueError``.
    """
    _chain_dim(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if shard_state_dim and STATE_AXIS not in names:
        raise ValueError(
            f"shard_state_dim=True needs a mesh with a '{STATE_AXIS}' axis "
            f"(see chain_state_mesh); got axes {names}")

    def place(x, axis, state_axis=None):
        if _is_state(x):
            return shard_sampler_state(mesh, x,
                                       shard_state_dim=shard_state_dim)
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() < 1:
            return _place(x, mesh, None)
        return _place(x, mesh, axis, state_axis)

    if not _is_state(state):
        axis = 0 if isinstance(state, torch.Tensor) and state.dim() else None
        return place(state, 0, _state_axis_of(state, "", state, axis)
                     if shard_state_dim else None)
    axis_of = getattr(type(state), "CHAIN_AXIS_INDEX", None) or {}
    out = []
    for name in state._fields:
        x, axis = getattr(state, name), axis_of.get(name, 0)
        out.append(place(x, axis, _state_axis_of(state, name, x, axis)
                         if shard_state_dim else None))
    return type(state)(*out)


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
    that was not a DTensor), ``chains`` is this rank's
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`; under a
    state split ``state_axes`` mirrors each leaf's state axis (``None``:
    whole) and ``state`` is the rank's
    :class:`~mini_mcmc_torch.parallel.collectives.StateGroup`, else both
    are ``None``."""

    mesh: object
    axes: object
    chains: ChainGroup
    state_axes: object = None
    state: Optional[StateGroup] = None

    def wrap(self, state):
        """The rank's local ``state`` as DTensors again."""
        return _wrap(state, self.axes, self.mesh, self.state_axes)

    def wrap_chains(self, x: torch.Tensor, axis: int = 0):
        """A local tensor whose axis ``axis`` holds this shard's chains
        (a sample cube, a per-chain read-out) as a DTensor; under a state
        split its last axis is the D-slice when it has one beside the
        chain axis (the JAX rule)."""
        dtensor, _, _ = _dtensor()
        last = x.dim() - 1
        state_axis = (last if self.state is not None and x.dim() >= 2
                      and last != axis else None)
        return dtensor.from_local(
            x, self.mesh, _placements(self.mesh, axis, state_axis),
            run_check=False)


def _wrap(x, axes, mesh, state_axes=None):
    if _is_state(x):
        if state_axes is None:
            state_axes = (None,) * len(x)
        return type(x)(*[_wrap(v, a, mesh, s)
                         for v, a, s in zip(x, axes, state_axes)])
    if axes is False or not isinstance(x, torch.Tensor):
        return x
    dtensor, _, _ = _dtensor()
    return dtensor.from_local(x, mesh, _placements(mesh, axes, state_axes),
                              run_check=False)


def local_state(state):
    """``(local, layout)``: the rank's local tensors of a state whose
    leaves are DTensors on a chain mesh and its :class:`StateLayout`, or
    ``(state, None)`` for a state with no DTensor leaf."""
    dtensor, shard, _ = _dtensor()
    found = {}

    def unwrap(x):
        if _is_state(x):
            triples = [unwrap(v) for v in x]
            return (type(x)(*[t[0] for t in triples]),
                    tuple(t[1] for t in triples),
                    tuple(t[2] for t in triples))
        if not isinstance(x, dtensor):
            return x, False, None
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
        sdim = _state_dim(mesh)
        q = None if sdim is None else x.placements[sdim]
        state_axis = q.dim if isinstance(q, shard) else None
        if state_axis is not None:
            d = found.setdefault("n_dim", x.shape[state_axis])
            if d != x.shape[state_axis]:
                raise ValueError(f"a state-split state's leaves hold {d} "
                                 f"and {x.shape[state_axis]} coordinates")
        return x.to_local(), axis, state_axis

    local, axes, state_axes = unwrap(state)
    if "mesh" not in found:
        return state, None
    mesh = found["mesh"]
    dim = _chain_dim(mesh)
    size, rank = mesh.size(dim), mesh.get_local_rank(dim)
    n = found.get("n_chains", 0)
    chains = ChainGroup(chain0=rank * (n // size), n_chains=n,
                        group=mesh.get_group(dim), size=size, rank=rank)
    if "n_dim" not in found:
        return local, StateLayout(mesh, axes, chains)
    sdim = _state_dim(mesh)
    size, rank = mesh.size(sdim), mesh.get_local_rank(sdim)
    d = found["n_dim"]
    state = StateGroup(d0=rank * (d // size), n_dim=d,
                       group=mesh.get_group(sdim), size=size, rank=rank,
                       mesh=mesh[STATE_AXIS])
    return local, StateLayout(mesh, axes, chains, state_axes, state)


def _implicit_replication():
    try:
        from torch.distributed.tensor.experimental import (
            implicit_replication)
    except ImportError:  # PyTorch before 2.4
        from torch.distributed._tensor.experimental import (
            implicit_replication)
    return implicit_replication()


def slice_view(x: torch.Tensor, state: StateGroup):
    """The rank's D-slice ``x`` (D on its last axis) as a DTensor of the
    global shape, ``Shard`` on the ``"state"`` axis's mesh; nothing is
    communicated."""
    dtensor, shard, _ = _dtensor()
    return dtensor.from_local(x, state.mesh, (shard(x.dim() - 1),),
                              run_check=False)


def on_slice(state: StateGroup, fn, *xs):
    """``fn`` on the DTensor views (:func:`slice_view`) of the rank's
    D-slices ``xs``, under DTensor's implicit replication: a plain tensor
    ``fn`` holds (a ``[D]`` table, a dataset) counts as replicated and is
    narrowed to the slice on the rank, with no collective."""
    with _implicit_replication():
        return fn(*[slice_view(x, state) for x in xs])


def whole(v, state: StateGroup) -> torch.Tensor:
    """A DTensor result on the state mesh (a sum over D) whole on every
    rank: the all-reduce of a partial sum, nothing for a replicated one
    or for a plain tensor (a result that read no D-slice, such as the
    integer walk's constant log q)."""
    dtensor, _, replicate = _dtensor()
    if not isinstance(v, dtensor):
        return v
    return v.redistribute(state.mesh, (replicate(),)).to_local()


def share(v, state: StateGroup) -> torch.Tensor:
    """This rank's share of a result ``v`` on the state mesh, the shares
    summing to ``v`` over the axis (``collectives.state_sum``): a partial
    sum's local part, else the whole value on the axis's rank 0 and zeros
    elsewhere (an exact sum). Nothing is communicated unless ``v`` is a
    partial reduction other than a sum."""
    dtensor, _, _ = _dtensor()
    if not isinstance(v, dtensor):
        return v if state.rank == 0 else torch.zeros_like(v)
    p = v.placements[0]
    if p.is_partial() and getattr(p, "reduce_op", "sum") == "sum":
        return v.to_local()
    v = whole(v, state)
    return v if state.rank == 0 else torch.zeros_like(v)


class SliceTarget:
    """``target`` as a rank of a state split sees it: each call takes the
    rank's ``[C, D / size]`` D-slice, runs the target on a DTensor view of
    it (``Shard(1)`` on the ``"state"`` axis's mesh, as GSPMD partitions
    the JAX package's density) and returns the rank's share: the
    gradient's D-slice, the log density whole (redistributed to
    ``Replicate()``: the all-reduce of a sum over D), or, from the
    ``*_share`` calls, the rank's share of it (:func:`share`), for the
    caller to sum over the axis beside its own sums in one all-reduce. An
    elementwise density's gradient needs no collective. The target runs
    under DTensor's implicit replication (:func:`on_slice`): a plain
    tensor it holds (a ``[D]`` per-coordinate scale) counts as replicated
    and is narrowed to the slice on the rank, with no collective. A
    density built from ops that DTensor has no rule for raises there."""

    def __init__(self, target, state):
        self.target = target
        self.state = state

    def _slice(self, g) -> torch.Tensor:
        _, shard, _ = _dtensor()
        return g.redistribute(self.state.mesh, (shard(1),)).to_local()

    def _call(self, name: str, x: torch.Tensor):
        """The target's method ``name`` on the DTensor view of ``x``."""
        return on_slice(self.state, getattr(self.target, name), x)

    def batch_logp(self, x: torch.Tensor) -> torch.Tensor:
        return whole(self._call("batch_logp", x), self.state)

    def batch_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self._slice(self._call("batch_grad", x))

    def batch_logp_and_grad(self, x: torch.Tensor):
        logp, grad = self._call("batch_logp_and_grad", x)
        return whole(logp, self.state), self._slice(grad)

    def batch_logp_and_grad_share(self, x: torch.Tensor):
        """``(this rank's share of logp [C], the gradient's D-slice)``."""
        logp, grad = self._call("batch_logp_and_grad", x)
        return share(logp, self.state), self._slice(grad)


class SliceProposal:
    """A random walk's :class:`~mini_mcmc_torch.models.Proposal` as a rank
    of a state split sees it: ``sample`` draws the global ``[C, D]`` shape
    around this rank's block (``collectives.state_call``), so the block is
    the unsharded run's; ``logp`` runs on DTensor views of the D-slices
    (their last axis) and returns the sum over D whole (one all-reduce a
    call: stack both q terms of a step into one call)."""

    def __init__(self, proposal, chains, state):
        self.proposal = proposal
        self.chains = chains
        self.state = state

    def sample(self, gen, x: torch.Tensor) -> torch.Tensor:
        from .collectives import state_call

        return state_call(self.chains, self.state,
                          lambda full: self.proposal.sample(gen, full), x)

    def logp(self, frm: torch.Tensor, to: torch.Tensor) -> torch.Tensor:
        return whole(on_slice(self.state, self.proposal.logp, frm, to),
                     self.state)
