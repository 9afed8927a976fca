"""Chain runners: Python loops over batched step kernels.

Counterpart of ``mini_mcmc_tpu/runner.py``. Every step already advances all
chains as one batched tensor, so a run is a loop over steps (``lax.scan``
in the JAX package). Collection conventions: MH/HMC (reference
``core.rs:55-73``) take ``n_discard + n_collect`` steps and record the last
``n_collect`` positions; NUTS (``nuts.rs:457-470``) records the position
at collection start as row 0 and takes ``n_collect + n_discard - 1``
steps.

Memory: one ``[n_collect, C, D]`` cube (``time_major=True``) or
``[C, n_collect, D]`` cube is allocated up front, and each step's or
block's rows are written straight into their slice of it: no stacking, no
concatenation and no final transpose, so the peak is one cube.

A sampler with a metric keeps its state in whitened coordinates and records
the user's: ``positions_of(state)`` maps a step's positions, and the block
runner's ``positions_map`` maps a block's ``[K, C, D]`` rows in place in the
cube after the block (``mini_mcmc_tpu/runner.py:31-65``, and the
``block_fn`` wrap of ``mini_mcmc_tpu/samplers.py:160-171``).

Every runner takes ``tracker=`` (a :class:`~mini_mcmc_torch.stats.
TrackerState`, or ``None``) and ``out=`` (a caller's cube, or a view of its
rows ``lo:hi``, in place of a fresh one) and returns ``(state, cube,
tracker)``. The tracker folds every step, burn-in included, in the user's
coordinates, as in the JAX package (``mini_mcmc_tpu/runner.py:35-65``);
under a chain mesh it folds the shard's chains at their global places
(``key.chains``).
Without a tracker a run launches and writes exactly what it would without
the keyword.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .stats import tracker_update, tracker_update_rows


def _default_positions_of(state):
    return state.positions


class StepKey(NamedTuple):
    """Randomness of one sampler step, or of the first step of a block.

    ``chains`` places a sharded run's chains among every shard's (a
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`: the first
    global chain, the global count, the group); ``None`` unsharded. The
    kernels draw as global chain ``chains.chain0 + c``, the lockstep tiers
    draw the global shape and keep their rows, and a loop's exit or a
    cross-chain mean reduces over the group.

    ``state`` places a state-split run's D-slice (a
    :class:`~mini_mcmc_torch.parallel.collectives.StateGroup`: the first
    global coordinate, the global D, the group); ``None`` when D is
    whole. The energy sums then cross the group."""

    seed: int  # the run's 64-bit Philox key
    step: int  # global step index within the run
    generator: torch.Generator  # on the positions' device
    chains: object = None  # a ChainGroup under a chain mesh
    state: object = None  # a StateGroup under a state split


def chain0(key) -> int:
    """The global index of the first chain a step of ``key`` runs: 0
    unsharded."""
    chains = getattr(key, "chains", None)
    return 0 if chains is None else chains.chain0


def key_chains(key):
    """``key.chains`` of a :class:`StepKey`, ``None`` for a bare
    generator."""
    return getattr(key, "chains", None)


def key_generator(key) -> torch.Generator:
    """The generator of ``key``: a :class:`StepKey`'s, or ``key`` itself
    when it is a ``torch.Generator`` (the functions that take a key, such
    as the SG-MCMC gradient estimators and the anneals, take either)."""
    return key.generator if isinstance(key, StepKey) else key


def _alloc_cube(positions: torch.Tensor, n_collect: int, time_major: bool,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """A fresh ``[n_collect, C, D]`` (``time_major``) or ``[C, n_collect,
    D]`` cube like ``positions``, or ``out`` once checked to be one."""
    c, d = positions.shape
    shape = (n_collect, c, d) if time_major else (c, n_collect, d)
    if out is None:
        return torch.empty(shape, dtype=positions.dtype,
                           device=positions.device)
    if (tuple(out.shape) != shape or out.dtype != positions.dtype
            or out.device != positions.device):
        raise ValueError(
            f"out must be a {positions.dtype} cube of shape {shape} on "
            f"{positions.device}; got {out.dtype} {tuple(out.shape)} on "
            f"{out.device}")
    return out


def _rows(cube: torch.Tensor, lo: int, hi: int, time_major: bool):
    """The ``[hi - lo, C, D]`` view of recorded rows ``lo:hi``."""
    return cube[lo:hi] if time_major else cube[:, lo:hi].transpose(0, 1)


def make_simple_runner(step_fn: Callable,
                       positions_of: Callable = _default_positions_of,
                       recorded: Callable = _default_positions_of):
    """A runner over one-step kernels, recording ``positions_of(state)``.

    ``run(state, key, n_collect, n_discard, *, time_major=False,
    tracker=None, out=None)`` takes ``n_collect + n_discard`` steps from
    global step ``key.step`` and returns ``(final_state, sample,
    tracker)``, ``sample`` ``[C, n_collect, D]`` (or ``[n_collect, C, D]``
    with ``time_major``) shaped like ``recorded(state)``.
    """

    def run(state, key: StepKey, n_collect: int, n_discard: int, *,
            time_major: bool = False, tracker=None, out=None):
        cube = _alloc_cube(recorded(state), n_collect, time_major, out)
        for i in range(n_discard + n_collect):
            state = step_fn(state, key._replace(step=key.step + i))
            if i < n_discard and tracker is None:
                continue
            pos = positions_of(state)
            if tracker is not None:
                tracker = tracker_update(tracker, pos, key.chains)
            if i >= n_discard:
                j = i - n_discard
                _rows(cube, j, j + 1, time_major)[0].copy_(pos)
        return state, cube, tracker

    return run


def make_scan_block_fn(step_fn: Callable, k: int) -> Callable:
    """K ``step_fn`` steps per call with the block contract
    ``block_fn(state, key, out=None) -> state`` (rows into ``out[i]``), so
    :func:`make_block_runner` takes it like the fused kernel's block."""

    def block_fn(state, key: StepKey, out=None):
        for i in range(k):
            state = step_fn(state, key._replace(step=key.step + i))
            if out is not None:
                out[i].copy_(state.positions)
        return state

    return block_fn


def make_block_runner(block_fn: Callable, block_size: int,
                      recorded: Callable = _default_positions_of,
                      positions_map: Callable | None = None):
    """A runner over K-step block kernels (same convention as
    :func:`make_simple_runner`).

    ``block_fn(state, key, out=None) -> state`` advances K sampler steps
    from global step ``key.step`` and writes every kept position into the
    ``[K, C, D]`` view ``out`` (the fused kernel writes the cube in place;
    recording is not thinned). ``recorded(state)`` is the ``[C, D]``
    tensor whose shape, dtype and device the cube takes: the positions, or
    for tempering the cold rung. ``positions_map``, a ``[..., D]`` map,
    takes each block's rows to the user's coordinates in place (the block
    writes the state's own). ``n_collect`` and ``n_discard`` must be
    multiples of K.

    Under a tracker the burn-in blocks write their rows into one reused
    ``[K, C, D]`` scratch buffer, which the tracker folds (mapped, under
    a metric); without one they write no rows.
    """
    k = block_size

    def run(state, key: StepKey, n_collect: int, n_discard: int, *,
            time_major: bool = False, tracker=None, out=None):
        if n_collect % k or n_discard % k:
            raise ValueError(
                f"n_collect={n_collect} and n_discard={n_discard} must be "
                f"multiples of the block size {k}"
            )
        like = recorded(state)
        cube = _alloc_cube(like, n_collect, time_major, out)
        scratch = (torch.empty((k,) + tuple(like.shape), dtype=like.dtype,
                               device=like.device)
                   if tracker is not None and n_discard else None)
        for lo in range(0, n_discard, k):
            state = block_fn(state, key._replace(step=key.step + lo),
                             scratch)
            if scratch is not None:
                tracker = tracker_update_rows(
                    tracker, scratch if positions_map is None
                    else positions_map(scratch), key.chains)
        for lo in range(0, n_collect, k):
            rows = _rows(cube, lo, lo + k, time_major)
            state = block_fn(
                state, key._replace(step=key.step + n_discard + lo), rows)
            if positions_map is not None:
                rows.copy_(positions_map(rows))
            if tracker is not None:
                tracker = tracker_update_rows(tracker, rows, key.chains)
        return state, cube, tracker

    return run


def make_initial_recording_runner(
        step_fn: Callable, positions_of: Callable = _default_positions_of):
    """A runner with the NUTS collection convention (reference
    ``nuts.rs:457-470``, ``mini_mcmc_tpu/runner.py:203``).

    ``run(state, key, n_collect, n_discard, *, time_major=False,
    tracker=None, out=None)`` takes ``n_collect + n_discard - 1`` steps
    from global step ``key.step``. Row 0 is the position at the start of
    collection: the current position when ``n_discard == 0``, else the
    state after step ``n_discard`` (the first ``n_discard - 1`` steps are
    not recorded). Rows, ``positions_of(state)``, go straight into one
    preallocated cube, as in :func:`make_simple_runner`; the tracker folds
    every step's, not the initial row.
    """

    def run(state, key: StepKey, n_collect: int, n_discard: int, *,
            time_major: bool = False, tracker=None, out=None):
        cube = _alloc_cube(state.positions, n_collect, time_major, out)
        if n_discard == 0 and n_collect > 0:
            _rows(cube, 0, 1, time_major)[0].copy_(positions_of(state))
            skip, first_row = 0, 1
        else:
            skip, first_row = max(n_discard - 1, 0), 0
        n_steps = max(n_collect + n_discard - 1, 0)
        for i in range(n_steps):
            state = step_fn(state, key._replace(step=key.step + i))
            if i < skip and tracker is None:
                continue
            pos = positions_of(state)
            if tracker is not None:
                tracker = tracker_update(tracker, pos, key.chains)
            if i >= skip:
                r = first_row + i - skip
                _rows(cube, r, r + 1, time_major)[0].copy_(pos)
        return state, cube, tracker

    return run
