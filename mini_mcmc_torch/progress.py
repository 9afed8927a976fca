"""Live progress reporting for sampling runs.

Counterpart of ``mini_mcmc_tpu/progress.py``, the lockstep form of the
reference's progress system (``core.rs:208-360``): one global bar and up to
five rotating per-chain bars with each chain's ``p(accept)`` EWMA. All
chains advance together, so a chain's bar rotates on the stats tick
instead of when the chain finishes.

The run goes in chunks through the sampler's runner, every chunk written
straight into one preallocated cube, and the streaming tracker
(:mod:`~mini_mcmc_torch.stats`) threaded through them on the device. At
most once a second (the reference's worker-side throttle, ``core.rs:105``)
the tracker's summary comes to the host in one transfer, the tick's one
sync; the bars are redrawn at most every 250 ms (``core.rs:230``).

Draws are keyed by place: one :class:`~mini_mcmc_torch.runner.StepKey`
serves the whole call and each chunk starts at its global step, so a
K-aligned ``progress_run`` gives the cube a single run gives from the same
key (the JAX package splits a key per chunk instead).
"""

from __future__ import annotations

import sys
import time
from typing import Callable

import torch

from . import stats as stats_mod
from .parallel.collectives import split

#: worker-side throttle: least seconds between stats fetches (core.rs:105)
_STATS_SECONDS = 1.0
#: UI-side throttle: least seconds between redraws (core.rs:230)
_REFRESH_SECONDS = 0.25
#: concurrent per-chain bars (core.rs:244: ``rxs.len().min(5)``)
_MAX_CHAIN_BARS = 5
#: chunks a run aims at: more give fresher stats and more host round trips
_TARGET_CHUNKS = 20


def _bar(done: int, total: int, width: int = 30) -> str:
    frac = done / max(total, 1)
    filled = int(width * frac)
    return "=" * filled + ">" + "-" * (width - filled - 1) \
        if filled < width else "=" * width


class _ProgressDisplay:
    """Global and rotating per-chain bars (the ``core.rs:236-324``
    layout)."""

    def __init__(self, n_chains: int, total: int, stream):
        self.n_chains = n_chains
        self.total = total
        self.stream = stream
        self.active = list(range(min(n_chains, _MAX_CHAIN_BARS)))
        self.next_active = len(self.active)
        self._prev_lines = 0
        self._isatty = bool(getattr(stream, "isatty", lambda: False)())

    def rotate(self) -> None:
        """Advance one displayed chain to the next undisplayed index.

        The reference rotates a bar when its chain finishes
        (``core.rs:301-317``); chains finish together here, so rotation
        rides the stats tick. Every chain is shown at most once, then
        rotation stops.
        """
        if self.next_active < self.n_chains:
            self.active = self.active[1:] + [self.next_active]
            self.next_active += 1

    def render(self, done: int, p_accept: float, p_accept_chains,
               max_rhat: float, elapsed: float) -> None:
        lines = [
            f"Global   [{_bar(done, self.total)}] {done}/{self.total} "
            f"({elapsed:.1f}s) | p(accept)≈{p_accept:.2f} "
            f"max(rhat)≈{max_rhat:.2f}"
        ]
        for idx in self.active:
            lines.append(
                f"Chain {idx:<2} [{_bar(done, self.total)}] "
                f"{done}/{self.total} | "
                f"p(accept)≈{float(p_accept_chains[idx]):.2f}"
            )
        if self._isatty and self._prev_lines:
            # move to the start of the previous block and overwrite
            self.stream.write(f"\x1b[{self._prev_lines}F")
            lines = [ln + "\x1b[K" for ln in lines]
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()
        self._prev_lines = len(lines)


def _chunk_size(total: int, k: int) -> int:
    """About ``total / _TARGET_CHUNKS`` steps, a multiple of ``k``; a
    multiple that divides ``total`` when one lies within twice that, so
    that the chunks come out equal."""
    chunk = max(k, (max(1, total) // _TARGET_CHUNKS) // k * k)
    for cand in range(chunk, 2 * chunk + 1, k):
        if total % cand == 0:
            return cand
    return chunk


def _tick(tracker, chains=None, state=None) -> tuple:
    """``(p_accept, p_accept_chains, max_rhat)`` on the host, in one
    transfer; a sharded run's global acceptance and R-hat beside its own
    chains' (``chains``, :func:`~mini_mcmc_torch.stats.tracker_stats`),
    the R-hat over every D-slice of a state split (``state``)."""
    host = torch.cat([
        stats_mod.tracker_stats(tracker, chains).p_accept.reshape(1),
        stats_mod.tracker_max_rhat(tracker, chains, state).reshape(1),
        tracker.p_accept_chains]).cpu()
    return float(host[0]), host[2:], float(host[1])


def progress_run(runner: Callable, state, key, n_collect: int,
                 n_discard: int, *, n_chains: int, dim: int, stream=None,
                 time_major: bool = False, block_size: int = 1,
                 tail_runner: Callable | None = None, initial_rows=None):
    """Run ``runner`` in chunks with a live progress block on ``stream``
    (stderr by default); returns ``(final_state, sample)``, ``sample``
    ``[C, n_collect, D]`` (``[n_collect, C, D]`` with ``time_major``).

    ``runner`` is one of :mod:`~mini_mcmc_torch.runner`'s, called as
    ``runner(state, key, n_collect, n_discard, time_major=, tracker=,
    out=)``. ``key`` is a :class:`~mini_mcmc_torch.runner.StepKey`; a
    chunk starting at step s of the run gets ``key._replace(step=key.step
    + s)``. With ``block_size`` K > 1 every chunk is a multiple of K and
    ``tail_runner`` (the per-step convention) takes the sub-K rest; a
    block that straddles the end of burn-in goes to a ``[K, C, D]``
    scratch and its kept rows to the cube.

    ``initial_rows``: ``[r0, C, D]`` rows recorded before the first step
    (the NUTS initial-recording convention); they fill the start of the
    cube and count toward ``n_collect``.
    """
    stream = stream if stream is not None else sys.stderr
    chains, d_slice = getattr(key, "chains", None), getattr(key, "state",
                                                            None)
    collective_ticks = ((chains is not None and chains.size > 1)
                        or split(d_slice))
    k = max(1, block_size)
    tail_runner = tail_runner if tail_runner is not None else runner
    n_initial = 0 if initial_rows is None else int(initial_rows.shape[0])
    total = n_collect + n_discard - n_initial
    chunk = _chunk_size(total, k)

    like = state.positions
    tracker = stats_mod.tracker_init(n_chains, dim, device=like.device)
    display = _ProgressDisplay(n_chains, total + n_initial, stream)
    shape = ((n_collect, n_chains, dim) if time_major
             else (n_chains, n_collect, dim))
    cube = torch.empty(shape, dtype=like.dtype, device=like.device)

    def rows(lo: int, hi: int) -> torch.Tensor:
        return cube[lo:hi] if time_major else cube[:, lo:hi]

    n_kept = 0
    if n_initial:
        rows(0, n_initial).copy_(initial_rows if time_major
                                 else initial_rows.transpose(0, 1))
        n_kept = n_initial

    def drive(fn, n_col: int, n_dis: int, out=None):
        """``n_dis + n_col`` steps from global step ``done``, the kept rows
        into the cube (or into ``out``)."""
        nonlocal state, tracker, n_kept, done
        if out is None:
            out = rows(n_kept, n_kept + n_col)
            n_kept += n_col
        state, _, tracker = fn(
            state, key._replace(step=key.step + done), n_col, n_dis,
            time_major=time_major, tracker=tracker, out=out)
        done += n_col + n_dis

    done = 0
    start_t = time.monotonic()
    last_render = 0.0
    last_stats = 0.0
    stats = None  # (p_accept, p_accept_chains, max_rhat) on the host
    while done < total:
        c = min(chunk, (total - done) // k * k)
        fn = runner
        if c == 0:  # the sub-K tail: the per-step convention
            c, fn = total - done, tail_runner
        burn = min(max(0, n_discard - done), c)
        straddle = burn % k if fn is runner else 0
        if straddle:
            # burn-in ends inside a block: the aligned burn-in, then that
            # block into a scratch of K rows of which the last K -
            # straddle are kept, then the rest of the chunk
            aligned = burn - straddle
            if aligned:
                drive(fn, 0, aligned)
            scratch = torch.empty((k, n_chains, dim) if time_major
                                  else (n_chains, k, dim),
                                  dtype=like.dtype, device=like.device)
            drive(fn, k, 0, out=scratch)
            kept = k - straddle
            rows(n_kept, n_kept + kept).copy_(
                scratch[straddle:] if time_major else scratch[:, straddle:])
            n_kept += kept
            if c - aligned - k:
                drive(fn, c - aligned - k, 0)
        else:
            drive(fn, c - burn, burn)

        now = time.monotonic()
        final = done >= total
        # a sharded run's tick reduces across ranks, so every rank ticks
        # at every chunk: a clock's tick would fall on one rank alone
        if (stats is None or now - last_stats >= _STATS_SECONDS or final
                or collective_ticks):
            # the stats tick: one transfer to the host, then rotate
            if stats is not None:
                display.rotate()
            stats = _tick(tracker, chains, d_slice)
            last_stats = now
        if now - last_render >= _REFRESH_SECONDS or final:
            display.render(done + n_initial, stats[0], stats[1], stats[2],
                           now - start_t)
            last_render = now

    stream.flush()
    return state, cube
