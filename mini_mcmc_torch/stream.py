"""Streaming chunked runs: production sampling in bounded memory.

Counterpart of ``mini_mcmc_tpu/stream.py``. ``run()`` fills one cube; a
run of millions of draws wants them on disk instead. :func:`stream_run`
runs the sampler in fixed-size chunks, hands each chunk to a consumer
while the device has the next one queued, and threads the streaming
tracker (:mod:`~mini_mcmc_torch.stats`) across the chunks, so the
acceptance and the live R-hat cover the whole run though no whole cube
exists.

Chunks are time-major ``[k, C, D]`` by default, the order of the
observation-major tensor schema. Draws are keyed by place: one
:class:`~mini_mcmc_torch.runner.StepKey` serves the whole call, each
chunk starting at its global step, so the chunks are the rows of the cube
a single run gives from the same key.
"""

from __future__ import annotations

import dataclasses

import torch

from . import stats as stats_mod


@dataclasses.dataclass
class StreamResult:
    """End-of-stream summary from the streaming tracker (no cube).

    ``p_accept``: the global acceptance EWMA (folded across chains as the
    reference's tracker folds it, ``stats.rs:110-123``); ``rhat``: the live
    streaming-moment R-hat per parameter ``[P]``, not a split R-hat (no
    whole series exists to split).
    """

    n_collected: int
    p_accept: torch.Tensor
    rhat: torch.Tensor

    def __str__(self) -> str:
        return (
            f"streamed {self.n_collected} draws/chain: "
            f"p(accept) mean {float(torch.mean(self.p_accept)):.3f}, "
            f"live R-hat max {float(torch.max(self.rhat)):.4f}"
        )


def stream_run(sampler, n_total: int, chunk_size: int, on_chunk=None,
               n_discard: int = 0, *, time_major: bool = True
               ) -> StreamResult:
    """Advance ``n_discard + n_total`` steps, delivering the collected
    draws in ``n_total / chunk_size`` chunks instead of one cube.

    Args:
        sampler: a sampler of this package; its state advances, so
            consecutive ``stream_run``/``run`` calls continue the chains.
        n_total: draws per chain, a multiple of ``chunk_size``.
        chunk_size: draws per chunk; each chunk is a fresh ``[chunk_size,
            C, D]`` tensor the consumer may keep.
        on_chunk: optional ``(chunk, start) -> None`` consumer, called with
            each chunk and its first observation's index, one chunk behind
            the sampler (chunk i once chunk i+1 is queued).
        n_discard: warm-up steps before the first chunk.
        time_major: chunk layout ``[k, C, D]`` (default) or ``[C, k, D]``.

    Returns:
        :class:`StreamResult`, from the tracker of the whole run.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if n_total % chunk_size != 0:
        raise ValueError(
            f"n_total={n_total} must be a multiple of chunk_size="
            f"{chunk_size} (equal chunks)"
        )
    block = sampler._progress_block_size
    if chunk_size % block != 0 or n_discard % block != 0:
        raise ValueError(
            f"chunk_size={chunk_size} and n_discard={n_discard} must be "
            f"multiples of the sampler's fused block size {block}"
        )
    # NUTS: its prepare pass (step-size search, adaptation horizon) runs
    # once, the divergences are snapshot so that last_run_divergences
    # covers the stream, and the chunks go through its SIMPLE runner: the
    # initial-recording convention would record the current position as
    # row 0 of every chunk. As in run_progress, the simple runner then
    # takes n_discard - 1 warm-up steps (NUTS takes n_collect + n_discard
    # - 1 steps in all).
    first_discard = n_discard
    runner = sampler._runner
    prepare = getattr(sampler, "_prepare_fn", None)
    if prepare is not None:
        sampler._snapshot_divergences()
        sampler._state = prepare(sampler._state, sampler._next_key(),
                                 n_discard)
        first_discard = max(0, n_discard - 1)
        runner = sampler._simple_runner
    key = sampler._next_key()
    local = sampler._state.positions
    tracker = stats_mod.tracker_init(
        *sampler._recorded(sampler._state).shape, device=local.device)
    step = 0
    pending = None
    for i in range(n_total // chunk_size):
        n_dis = first_discard if i == 0 else 0
        sampler._state, chunk, tracker = runner(
            sampler._state, key._replace(step=key.step + step), chunk_size,
            n_dis, time_major=time_major, tracker=tracker)
        chunk = sampler._out(chunk, 1 if time_major else 0)
        step += chunk_size + n_dis
        if on_chunk is not None:
            if pending is not None:
                on_chunk(*pending)
            pending = (chunk, i * chunk_size)
    if pending is not None:
        on_chunk(*pending)
    return StreamResult(
        n_collected=n_total,
        p_accept=stats_mod.tracker_stats(tracker, key.chains).p_accept,
        rhat=stats_mod.tracker_rhat(tracker, key.chains, key.state),
    )
