"""Batched Metropolis-Hastings step kernel (counterpart of
``mini_mcmc_tpu/ops/mh.py``).

All chains advance in lockstep as a ``[C, D]`` batch: propose, evaluate the
target and both proposal log densities, and accept with a ``where``
(reference ``MHMarkovChain::step``, ``metropolis_hastings.rs:303-315``).
Integer states stay integer; the cached target log density is carried in
the state, so each step evaluates the target once.

Randomness: the plain tier draws the proposal and the accept uniform from
``key.generator``; the fused tier (``use_pallas="full"``) draws both from
the Philox stream at ``(key.seed, chain, key.step, draw)`` inside Kernel 5
(``kernels/mh_full.py``). Under a chain mesh a shard draws what the
unsharded run draws for its chains (``parallel/collectives.py``).

Under a state split (``key.state``: D split over a ``"state"`` axis) the
plain step proposes the global ``[C, D]`` draw's block and evaluates the
target and both q terms on DTensor views of its D-slice
(``parallel.mesh.SliceTarget``, ``SliceProposal``): two all-reduces a
step, the logp's and the q terms' (both in one call). The accept uniform
is the chain's, the same on every state shard, so each chain takes one
decision on all its shards. The sampler admits only a proposal that sets
``Proposal.takes_state_split`` (a random walk) there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.collectives import (
    chain_call,
    chain_draw,
    gather_chains,
    split,
)
from ..parallel.mesh import SliceProposal, SliceTarget
from ..runner import StepKey, chain0, make_scan_block_fn
from .kernels.mh_full import mh_multistep, propose_form


class MHState(NamedTuple):
    positions: torch.Tensor  # [C, D], float or integer dtype
    logp: torch.Tensor  # [C] cached target log density at positions

    #: the state-dimension axis per field for ``parallel.
    #: shard_sampler_state(..., shard_state_dim=True)``
    STATE_AXIS_INDEX = {"positions": 1}


def _plain_mh_step(target, proposal, state: MHState, key: StepKey):
    """One batched MH update; returns ``(MHState, log_accept [C])``.

    Keeps both q terms: ``log alpha = (logp' + log q(x | x')) - (logp +
    log q(x' | x))`` and accepts iff ``log alpha > ln(u)``, strictly
    (``metropolis_hastings.rs:309-313``); HMC's accept is ``>=``."""
    pos = state.positions
    gen = key.generator
    st = key.state
    if split(st):  # D-slices: the sums over D cross the state axis
        walk = SliceProposal(proposal, key.chains, st)
        proposed = walk.sample(gen, pos)
        proposed_lp = SliceTarget(target, st).batch_logp(proposed)
        log_q_fwd, log_q_bwd = walk.logp(torch.stack([pos, proposed]),
                                         torch.stack([proposed, pos]))
    else:
        # a shard proposes from the global shape's draws (collectives.py)
        proposed = chain_call(key.chains,
                              lambda x: proposal.sample(gen, x), pos)
        proposed_lp = target.batch_logp(proposed)
        log_q_fwd = proposal.logp(pos, proposed)
        log_q_bwd = proposal.logp(proposed, pos)
    log_accept = (proposed_lp + log_q_bwd) - (state.logp + log_q_fwd)
    u = chain_draw(key.chains, lambda s: torch.rand(
        s, generator=gen, dtype=log_accept.dtype, device=pos.device),
        (pos.shape[0],))
    accept = log_accept > torch.log(u)  # NaN compares False
    positions = torch.where(accept[:, None], proposed, pos)
    logp = torch.where(accept, proposed_lp, state.logp)
    return MHState(positions, logp), log_accept


def mh_step_alpha(target, proposal_family):
    """Adaptation hook for the proposal scale: ``proposal_family(factor) ->
    Proposal`` (``Proposal.scaled``). Returns ``step_eps(state, key,
    factor) -> (MHState, mean_alpha)``, ``mean_alpha`` the cross-chain mean
    of ``min(1, exp(log_accept))`` with NaN counted as 0 (over every shard
    under a chain mesh)."""

    def step_eps(state: MHState, key: StepKey, factor):
        state, log_accept = _plain_mh_step(
            target, proposal_family(float(factor)), state, key)
        alpha = torch.clamp(torch.exp(log_accept), max=1.0)
        return state, torch.mean(torch.nan_to_num(
            gather_chains(alpha, key.chains), nan=0.0))

    return step_eps


def mh_kernel(target, proposal, *, use_pallas=False, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for batched MH.

    ``init_fn(positions [C, D], state=None) -> MHState`` (``state``: the
    ``StateGroup`` of a rank's D-slice);
    ``step_fn(state, key: StepKey) -> MHState``.

    ``use_pallas="full"`` runs whole steps in Kernel 5
    (``kernels/mh_full.py``): it needs a symmetric proposal with a fused
    form, built in (``Proposal.cuda_functor``) or the user's
    (``propose_words`` and ``cuda_words``, the twin's, with
    ``cuda_source`` on CUDA tensors; ``ops/mh.py:119-122`` in the JAX
    package requires ``propose_dc`` likewise); on CUDA tensors the target
    runs as a built-in functor or as its own C++ (``Target.cuda_source``,
    or generated from its batch form). ``steps_per_call`` > 1 attaches ``step_fn.block_fn(state, key,
    out=None) -> state`` and ``step_fn.block_size`` = K: one Kernel 5
    launch per K steps with ``"full"``, else K calls of ``step_fn``.
    Every kept position is recorded; nothing is thinned.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    full = False
    if use_pallas:
        if use_pallas != "full":
            raise ValueError(
                "MH has no trajectory to fuse separately: the only fused "
                f'variant is use_pallas="full"; got {use_pallas!r}')
        if not proposal.symmetric:
            raise ValueError(
                'use_pallas="full" requires a symmetric proposal (the '
                "kernel skips the q terms, which cancel)")
        propose_form(proposal)  # raises for a proposal without a fused form
        full = True

    def init_fn(positions: torch.Tensor, state=None) -> MHState:
        """The state at ``positions``; ``state`` (a ``StateGroup``) when
        they are a rank's D-slice."""
        tgt = SliceTarget(target, state) if split(state) else target
        return MHState(positions, tgt.batch_logp(positions))

    def step_fn(state: MHState, key: StepKey) -> MHState:
        if full:
            return MHState(*mh_multistep(target, proposal, state.positions,
                                         state.logp, key.seed, key.step, 1,
                                         chain0=chain0(key)))
        return _plain_mh_step(target, proposal, state, key)[0]

    if steps_per_call > 1:
        k = steps_per_call
        if full:

            def block_fn(state: MHState, key: StepKey, out=None):
                return MHState(*mh_multistep(
                    target, proposal, state.positions, state.logp, key.seed,
                    key.step, k, out, chain0=chain0(key)))
        else:
            block_fn = make_scan_block_fn(step_fn, k)
        step_fn.block_fn = block_fn
        step_fn.block_size = k

    return init_fn, step_fn
