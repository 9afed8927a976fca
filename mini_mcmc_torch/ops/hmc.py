"""Batched Hamiltonian Monte Carlo step kernel.

Counterpart of ``mini_mcmc_tpu/ops/hmc.py``: all chains advance in lockstep
as ``[C, D]`` tensors, with the cached half-step gradient (one gradient
evaluation per leapfrog step) and the cached logp/gradient carried in the
state.

Randomness: each step receives a :class:`StepKey`. The non-fused tiers
(``use_pallas=False`` and ``True``) and the step-size jitter draw from
``key.generator``, a ``torch.Generator`` on the positions' device; the
fused tier (``"full"``) draws momentum and accept uniforms from the Philox
stream at ``(key.seed, chain, key.step)`` inside the kernel, and so does
the separable tier (``"separable"``) inside Kernel 7; the step-size jitter
alone comes from ``key.generator`` there.

Under a chain mesh (``key.chains``) the generator's draws are the global
shape's, narrowed to the shard's chains, the kernels take the shard's first
global chain as ``chain0``, and ``step_eps``'s mean acceptance covers every
shard (``parallel/collectives.py``).

Under a state split (``key.state``: D split over a ``"state"`` axis) the
lockstep step draws the global ``[C, D]`` momenta narrowed to its block,
runs the target on a DTensor view of its D-slice
(``parallel.mesh.SliceTarget``) and sums the kinetic energies over the axis
(one all-reduce of ``[2, C]``); the separable step runs Kernel 7's
trajectory at the slice (``d0``) and all-reduces its ``[3, C]`` sums, one
all-reduce a step, before the accept. Every shard of a chain draws the
same accept uniform and so takes the same decision. A state axis of one
rank runs the unsplit code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.collectives import (
    chain_draw,
    gather_chains,
    split,
    state_draw,
    state_sum,
)
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, chain0, make_scan_block_fn
from .kernels.hmc import leapfrog_trajectory, leapfrog_trajectory_plain
from .kernels.hmc_full import hmc_multistep
from .kernels.hmc_sep import hmc_separable_step


class HMCState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C] cached target log density at positions
    grad: torch.Tensor  # [C, D] cached gradient at positions

    #: the state-dimension axis per field for ``parallel.
    #: shard_sampler_state(..., shard_state_dim=True)``
    STATE_AXIS_INDEX = {"positions": 1, "grad": 1}


class HMCSepState(NamedTuple):
    """State of the separable tier: no gradient cache, since Kernel 7
    derives the gradient coordinate by coordinate."""

    positions: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C] cached target log density at positions

    STATE_AXIS_INDEX = {"positions": 1}


def hmc_kernel(target, step_size: float, n_leapfrog: int,
               use_pallas=False, jitter: float = 0.0,
               steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for batched HMC.

    ``init_fn(positions [C, D], state=None) -> HMCState`` (``state``: the
    ``StateGroup`` of a rank's D-slice);
    ``step_fn(state, key: StepKey) -> HMCState``, with
    ``step_fn.step_eps(state, key, eps) -> (state, alpha)``.

    ``use_pallas`` selects the fused hand-written kernel tier: ``True``
    runs the trajectory in Kernel 1 (``kernels/hmc.py``) with momentum and
    accept drawn here; ``"full"`` runs whole steps in Kernel 2
    (``kernels/hmc_full.py``). On CPU tensors both run the kernels' plain
    twins; on CUDA tensors the target needs a ``cuda_functor``.

    ``use_pallas="separable"`` is the large-D tier for coordinate-separable
    targets (``ops/hmc.py:192-215`` in the JAX package): a step is one
    Kernel 7 launch (``kernels/hmc_sep.py:hmc_separable_step``), the
    momentum, the trajectory and the accept inside it (past its cluster
    limit the trajectory and a PyTorch accept); the state is an
    :class:`HMCSepState`, its logp pinned to the positions' dtype. The
    sampler validates separability (``models.base.validate_separable``).

    ``jitter`` > 0 scales the step size per sampler step by one shared
    Uniform[1 - jitter, 1 + jitter] factor (Neal 2011).

    ``steps_per_call`` > 1 attaches ``step_fn.block_fn(state, key,
    out=None) -> state`` and ``step_fn.block_size`` = K: K sampler steps
    per call, each kept position written to ``out[i]`` of a ``[K, C, D]``
    view when ``out`` is given. With ``"full"`` the block is one Kernel 2
    launch; otherwise K calls of ``step_fn``.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if use_pallas not in (False, True, "full", "separable"):
        raise ValueError("use_pallas must be False, True, 'full' or "
                         f"'separable'; got {use_pallas!r}")
    full = use_pallas == "full"
    separable = use_pallas == "separable"
    traj = leapfrog_trajectory if use_pallas else leapfrog_trajectory_plain
    sep_tables = target.sep_forms()[1] if separable else ()
    tables_on = {}  # the [n_tables, D] table tensor per (device, dtype)

    def _tables(like: torch.Tensor, d0: int = 0) -> torch.Tensor:
        """The tables of ``like``'s columns, a D-slice from ``d0``."""
        key = (like.device, like.dtype, d0, like.shape[1])
        if key not in tables_on:
            tables_on[key] = (
                torch.cat([t.to(like.device, like.dtype)
                           for t in sep_tables])[:, d0:d0 + like.shape[1]]
                .contiguous()
                if sep_tables else like.new_empty((0, like.shape[1])))
        return tables_on[key]

    def init_fn(positions: torch.Tensor, state=None):
        tgt = SliceTarget(target, state) if split(state) else target
        if separable:
            return HMCSepState(
                positions, tgt.batch_logp(positions).to(positions.dtype))
        logp, grad = tgt.batch_logp_and_grad(positions)
        return HMCState(positions, logp, grad)

    def _eps(key: StepKey, n: int, like: torch.Tensor) -> torch.Tensor:
        """``[n]`` step sizes, jittered from ``key.generator``."""
        if jitter > 0.0:
            u = torch.rand((n,), generator=key.generator, dtype=like.dtype,
                           device=like.device)
            return step_size * (1.0 + jitter * (2.0 * u - 1.0))
        return torch.full((n,), step_size, dtype=like.dtype,
                          device=like.device)

    def sep_step(state: HMCSepState, key: StepKey, eps):
        """One separable-tier step (``ops/hmc.py:_sep_step`` in the JAX
        package), Kernel 7's whole step: the new state and each chain's
        acceptance probability ``alpha_c`` (NaN counted as 0)."""
        pos = state.positions
        eps = torch.as_tensor(eps, dtype=pos.dtype,
                              device=pos.device).reshape(1)
        st = key.state
        # a D-slice: the two-pass form, its [3, C] sums over the state axis
        d0, n_dim, reduce = ((st.d0, st.n_dim, lambda s: state_sum(s, st))
                             if split(st) else (0, None, None))
        positions, logp, alpha_c = hmc_separable_step(
            target, pos, state.logp, eps, n_leapfrog, key.seed, key.step,
            _tables(pos, d0), chain0=chain0(key), d0=d0, n_dim=n_dim,
            reduce=reduce)
        return HMCSepState(positions, logp), alpha_c

    def plain_step(state: HMCState, key: StepKey, eps):
        """One non-fused HMC step at step size ``eps``: the new state and
        each chain's acceptance probability ``alpha_c``."""
        pos = state.positions
        gen = key.generator
        like = dict(dtype=pos.dtype, device=pos.device)
        st = key.state
        mom0 = state_draw(key.chains, st, lambda s: torch.randn(
            s, generator=gen, **like), pos.shape)
        ke0 = torch.sum(mom0 * mom0, dim=1)
        pos_prop, mom_prop, logp_prop, grad_prop = traj(
            SliceTarget(target, st) if split(st) else target, pos, mom0,
            state.grad, eps, n_leapfrog
        )
        ke1 = torch.sum(mom_prop * mom_prop, dim=1)
        if split(st):  # the D-slices' shares, summed over the axis
            ke0, ke1 = state_sum(torch.stack([ke0, ke1]), st)
        h_current = -state.logp + 0.5 * ke0
        h_proposed = -logp_prop + 0.5 * ke1
        # accept iff H_cur - H_prop >= ln(u) per chain (hmc.rs:343-376)
        accept_logp = h_current - h_proposed
        alpha_c = torch.exp(torch.clamp(accept_logp, max=0.0))
        u = chain_draw(key.chains, lambda s: torch.rand(
            s, generator=gen, **like), (pos.shape[0],))
        accept = accept_logp >= torch.log(u)  # NaN compares False
        positions = torch.where(accept[:, None], pos_prop, pos)
        logp = torch.where(accept, logp_prop, state.logp)
        grad = torch.where(accept[:, None], grad_prop, state.grad)
        return HMCState(positions, logp, grad), alpha_c

    def step_eps(state, key: StepKey, eps):
        """One non-fused step at step size ``eps`` and the cross-chain
        mean acceptance probability (NaN counts as 0), over every shard
        under a chain mesh (one all-gather of ``[C]``)."""
        if separable:
            state, alpha_c = sep_step(state, key, eps)
            return state, gather_chains(alpha_c, key.chains).mean()
        state, alpha_c = plain_step(state, key, eps)
        return state, torch.mean(torch.nan_to_num(
            gather_chains(alpha_c, key.chains), nan=0.0))

    def step_fn(state, key: StepKey):
        eps = _eps(key, 1, state.positions)
        if full:
            return HMCState(*hmc_multistep(
                target, state.positions, state.logp, state.grad, eps,
                n_leapfrog, key.seed, key.step, chain0=chain0(key),
            ))
        state, _ = (sep_step if separable else plain_step)(state, key,
                                                           eps[0])
        return state

    step_fn.step_eps = step_eps

    if steps_per_call > 1:
        k = steps_per_call
        if full:

            def block_fn(state: HMCState, key: StepKey, out=None):
                return HMCState(*hmc_multistep(
                    target, state.positions, state.logp, state.grad,
                    _eps(key, k, state.positions), n_leapfrog, key.seed,
                    key.step, out, chain0=chain0(key),
                ))
        else:
            block_fn = make_scan_block_fn(step_fn, k)
        step_fn.block_fn = block_fn
        step_fn.block_size = k

    return init_fn, step_fn
