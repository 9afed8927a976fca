"""Every collective of the port, and the draws of a chain or state shard.

A run over a chain mesh (``parallel/mesh.py``) advances each rank's own
chains, its shard, and reaches the other ranks only through the functions
here: :func:`all_reduce`, :func:`all_gather`, :func:`broadcast`,
:func:`barrier` and the two built on them, :func:`any_chains` (a loop's
exit over every shard's chains) and :func:`gather_chains` (a cross-chain
statistic over all of them). Each adds one to :data:`COUNTS` where it calls
``torch.distributed``, as the kernels count their launches, so a test can
pin what a run communicates (the JAX package pins its compiled HLO,
``tests/test_parallel.py``).

Unsharded, ``chains`` is ``None`` and nothing here communicates:
:func:`any_chains` is ``bool(flag.any())`` and :func:`chain_draw`
``draw(shape)``, so a run without a mesh makes the same launches and gives
the same bits as before.

A shard keys its draws by global chain. The kernels take the shard's first
global chain as ``chain0``. The lockstep tiers draw from a
``torch.Generator`` whose numbers depend on the shape drawn, so
:func:`chain_draw` draws the global shape and keeps the shard's rows: every
rank's generator advances alike, and a shard's rows equal the unsharded
run's.

A state split over a ``"state"`` axis (``mesh.chain_state_mesh``) keeps a
D-slice of every chain on each rank of that axis (:class:`StateGroup`).
The lockstep steps sum a chain's energies over its D-slice and then over
the axis (:func:`state_sum`, one all-reduce), and draw the global
``[C, D]`` shape (tempering's ``[T, D, C]``), narrowed to their chains
and coordinates (:func:`state_draw`, :func:`state_call`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

#: calls of each collective since the last :func:`reset_counts`;
#: ``all_reduce_scalar`` counts the all-reduces of one element (a loop's
#: exit, a count), which ``all_reduce`` counts too
COUNTS = {"all_reduce": 0, "all_reduce_scalar": 0, "all_gather": 0,
          "broadcast": 0, "barrier": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def counts() -> dict:
    """A copy of :data:`COUNTS`."""
    return dict(COUNTS)


class ChainGroup(NamedTuple):
    """A rank's place among the shards of a chain axis."""

    chain0: int  # global index of this shard's first chain
    n_chains: int  # chains over all shards
    group: object  # the axis's torch.distributed ProcessGroup
    size: int  # shards on the axis
    rank: int  # this shard's place on the axis


class StateGroup(NamedTuple):
    """A rank's place among the shards of a state (``"state"``) axis: its
    D-slice ``[d0, d0 + D / size)``."""

    d0: int  # global index of this shard's first coordinate
    n_dim: int  # coordinates over all shards
    group: object  # the axis's torch.distributed ProcessGroup
    size: int  # shards on the axis
    rank: int  # this shard's place on the axis
    mesh: object = None  # the axis's 1-D DeviceMesh, for DTensor views


def split(state: StateGroup | None) -> bool:
    """Whether ``state`` splits D over more than one rank."""
    return state is not None and state.size > 1


def _dist():
    import torch.distributed as dist
    return dist


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``op``: sum, max or min)."""
    dist = _dist()
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_scalar"] += x.numel() == 1
    dist.all_reduce(x, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return x


def all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``axis`` in
    rank order."""
    dist = _dist()
    COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``x`` from the group's rank ``src`` (a group rank), in place."""
    dist = _dist()
    COUNTS["broadcast"] += 1
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def barrier(group) -> None:
    COUNTS["barrier"] += 1
    _dist().barrier(group=group)


def any_chains(flag: torch.Tensor, chains: ChainGroup | None) -> bool:
    """Whether ``flag`` holds anywhere: in this shard alone unsharded,
    else in any shard of ``chains`` (one scalar all-reduce). A loop that
    exits on it runs alike on every rank."""
    if chains is None:
        return bool(flag.any())
    hit = flag.any().to(torch.int32).reshape(1)
    return bool(all_reduce(hit, chains.group, "max")[0])


def max_chains(x: torch.Tensor, chains: ChainGroup | None) -> int:
    """The largest entry of the integer tensor ``x`` over every shard, on
    the host (``-1`` for no entry anywhere)."""
    m = (x.max() if x.numel() else torch.tensor(-1, device=x.device))
    if chains is None:
        return int(m)
    return int(all_reduce(m.to(torch.int64).reshape(1), chains.group,
                          "max")[0])


def gather_chains(x: torch.Tensor, chains: ChainGroup | None,
                  axis: int = 0) -> torch.Tensor:
    """``x`` over every shard's chains (its chain axis ``axis``): ``x``
    itself unsharded, else one all-gather, the rows in global order. A
    statistic over the result is the unsharded run's, bit for bit."""
    if chains is None:
        return x
    return all_gather(x, chains.group, axis)


def chain_draw(chains: ChainGroup | None, draw: Callable, shape,
               axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` for this shard's chains, the chain axis ``axis`` of
    ``shape`` the shard's count: unsharded (or on a one-rank mesh)
    ``draw(shape)`` itself, else the draw of the global shape narrowed to
    the shard's rows."""
    if chains is None or chains.size == 1:
        return draw(tuple(shape))
    full = list(shape)
    local = full[axis]
    full[axis] = chains.n_chains
    return draw(tuple(full)).narrow(axis, chains.chain0, local)


def state_draw(chains: ChainGroup | None, state: StateGroup | None,
               draw: Callable, shape, chain_axis: int = 0,
               state_axis: int = 1) -> torch.Tensor:
    """``draw(shape)`` for this rank's block, ``shape`` holding the rank's
    chains on ``chain_axis`` and its D-slice on ``state_axis`` (``[C, D]``
    by default; tempering's ``[T, D, C]`` passes 2 and 1):
    :func:`chain_draw` unless the state is split, else the draw of the
    global shape narrowed to the rank's chains and D-slice, so that every
    rank's generator advances alike and a block equals the unsharded
    run's. It costs one global draw a rank."""
    if not split(state):
        return chain_draw(chains, draw, shape, chain_axis)
    full = list(shape)
    c, d = full[chain_axis], full[state_axis]
    full[chain_axis] = c if chains is None else chains.n_chains
    full[state_axis] = state.n_dim
    c0 = 0 if chains is None else chains.chain0
    return (draw(tuple(full)).narrow(chain_axis, c0, c)
            .narrow(state_axis, state.d0, d))


def state_sum(x: torch.Tensor, state: StateGroup | None) -> torch.Tensor:
    """A sum over D of which ``x`` holds this rank's D-slice's share,
    summed over every shard of the state axis (one all-reduce, counted
    as ``all_reduce``); ``x`` itself unless the state is split."""
    if not split(state):
        return x
    return all_reduce(x.contiguous(), state.group)


def gather_state(x: torch.Tensor, state: StateGroup | None,
                 axis: int = -1) -> torch.Tensor:
    """``x``'s D-slice along ``axis`` gathered over every shard of the
    state axis (one all-gather), the coordinates in global order;
    ``x`` itself unless the state is split."""
    if not split(state):
        return x
    return all_gather(x, state.group, axis % x.dim())


def chain_call(chains: ChainGroup | None, fn: Callable, x: torch.Tensor,
               axis: int = 0) -> torch.Tensor:
    """``fn(x)`` for a function that draws in ``x``'s shape (a proposal's
    or a conditional's ``sample``): sharded, ``fn`` runs on a global-shape
    tensor with this shard's rows in place (zeros elsewhere) and its
    result is narrowed back, so it draws what the unsharded run draws."""
    if chains is None or chains.size == 1:
        return fn(x)
    shape = list(x.shape)
    local = shape[axis]
    shape[axis] = chains.n_chains
    full = x.new_zeros(shape)
    full.narrow(axis, chains.chain0, local).copy_(x)
    return fn(full).narrow(axis, chains.chain0, local)


def state_call(chains: ChainGroup | None, state: StateGroup | None,
               fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a function that draws in the ``[C, D]`` shape of
    ``x`` (a random walk's ``sample``): :func:`chain_call` unless the state
    is split, else ``fn`` on a global ``[C, D]`` tensor with this rank's
    block in place (zeros elsewhere), narrowed back to the block, so that
    it draws what the unsharded run draws. A draw at one coordinate must
    not depend on the row's other coordinates."""
    if not split(state):
        return chain_call(chains, fn, x)
    c, d = x.shape
    n = c if chains is None else chains.n_chains
    c0 = 0 if chains is None else chains.chain0
    full = x.new_zeros((n, state.n_dim))
    full[c0:c0 + c, state.d0:state.d0 + d] = x
    return fn(full)[c0:c0 + c, state.d0:state.d0 + d]
