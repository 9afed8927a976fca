"""Parallel tempering / replica exchange (counterpart of
``mini_mcmc_tpu/ops/tempering.py``).

Each logical chain runs T replicas against the tempered densities
``beta_t * logp`` for a ladder ``1 = beta_0 > ... > beta_{T-1} > 0``. A step
is ``n_inner`` lockstep random-walk Metropolis sweeps over all ``T * C``
replicas, rung t proposing at ``sigma / sqrt(beta_t)``, then one swap sweep
between neighbouring rungs, even pairs on even steps and odd pairs on odd
ones, with ``log alpha = (beta_t - beta_{t+1}) (logp(x_{t+1}) -
logp(x_t))``, and a per-(pair, chain) EWMA of the swap accepts. Only the
cold rung is recorded.

The state keeps the JAX layout ``[T, D, C]`` (chains last: a thread per
chain reads it coalesced too). :func:`pt_step` performs one step from
explicit draws; the plain tier feeds it ``key.generator`` draws, Kernel 8's
twin (``kernels/pt_full.py``) feeds it Philox draws, and the parity tests
feed it the JAX path's own. Accepts and swaps are true selects, so a
``-inf`` log density (bounded support) stays ``-inf`` and never turns into
NaN. The TPU rule that the chain count be a multiple of 1024 does not
apply.

Under a state split (``key.state``: D split over a ``"state"`` axis, the
state's axis 1) each rank walks its D-slice of every replica: its block
of the global ``[T, D, C]`` noise, the ladder's scales at its
coordinates, and the rung log densities on a DTensor view of the slice
(``parallel.mesh.SliceTarget``), summed over D whole on every rank: one
``[T C]`` all-reduce an inner sweep. The swaps read only ``raw_logp``,
whole everywhere, so they need none, and every shard of a chain accepts
and swaps alike. (The JAX package's rule splits a leaf's last axis, here
the chains, and so leaves PT's D whole on every state rank.) Kernel 8
keeps a replica's whole row and refuses a split.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel.collectives import chain_draw, split, state_draw
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, chain0
from .kernels.pt_full import make_ladder, pt_multistep

#: EWMA weight of the swap-acceptance diagnostic
#: (``mini_mcmc_tpu/ops/tempering.py:65``)
SWAP_EWMA_ALPHA = 0.05


class PTState(NamedTuple):
    positions: torch.Tensor  # [T, D, C]; rung 0 is cold (beta = 1)
    raw_logp: torch.Tensor  # [T, C] untempered log density
    parity: int  # which pair parity swaps next (a host int)
    swap_accept: torch.Tensor  # [T-1, C] EWMA of the swap accepts

    #: chain axis per field for ``parallel.shard_sampler_state``
    #: (``mini_mcmc_tpu/ops/tempering.py:84-89``): the chains sit behind
    #: the ladder, so the swap sweep's ladder-axis shifts stay local
    CHAIN_AXIS_INDEX = {"positions": 2, "raw_logp": 1, "swap_accept": 1,
                        "parity": None}
    #: the state-dimension axis per field (``shard_state_dim=True``): D
    #: sits before the chains, so the JAX rule's last axis would be wrong
    STATE_AXIS_INDEX = {"positions": 1}


def geometric_betas(n_temps: int, beta_min: float = 0.01) -> tuple:
    """A geometric ladder ``1 -> beta_min`` of ``n_temps`` rungs."""
    if n_temps < 2:
        raise ValueError(f"n_temps must be >= 2, got {n_temps}")
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"beta_min must be in (0, 1), got {beta_min}")
    return tuple(float(b) for b in np.geomspace(1.0, beta_min, n_temps))


def tune_betas(betas: Sequence[float], swap_acceptance,
               n_temps: Optional[int] = None) -> tuple:
    """Re-space a ladder from measured swap rates: knots at equal
    increments of the communication barrier (Syed et al. 2021, sec. 5.2),
    the endpoints kept; ``n_temps`` resizes it. Host numpy, as
    ``mini_mcmc_tpu/ops/tempering.py:105-155``."""
    betas = np.asarray(betas, np.float64)
    if torch.is_tensor(swap_acceptance):
        swap_acceptance = swap_acceptance.detach().cpu().numpy()
    acc = np.asarray(swap_acceptance, np.float64)
    if betas.ndim != 1 or acc.shape != (betas.shape[0] - 1,):
        raise ValueError(
            f"swap_acceptance must have length len(betas)-1; got "
            f"{acc.shape} for {betas.shape[0]} betas")
    if n_temps is None:
        n_temps = betas.shape[0]
    if n_temps < 2:
        raise ValueError(f"n_temps must be >= 2, got {n_temps}")
    rej = np.clip(1.0 - acc, 1e-6, 1.0)
    lam = np.concatenate([[0.0], np.cumsum(rej)])
    new = np.interp(np.linspace(0.0, lam[-1], n_temps), lam, betas)
    new[0], new[-1] = betas[0], betas[-1]
    for i in range(1, n_temps):  # zero-width barrier segments
        if new[i] >= new[i - 1]:
            new[i] = new[i - 1] * 0.999999
    return tuple(float(b) for b in new)


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """[T, ...] -> rung t holds rung t+1's value (last rung: itself)."""
    return torch.cat([x[1:], x[-1:]], dim=0)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """[T, ...] -> rung t holds rung t-1's value (first rung: itself)."""
    return torch.cat([x[:1], x[:-1]], dim=0)


def rung_logp(target, positions: torch.Tensor) -> torch.Tensor:
    """``[T, D, C]`` replicas -> ``[T, C]`` untempered log densities."""
    t, d, c = positions.shape
    flat = positions.transpose(1, 2).reshape(t * c, d)
    return target.batch_logp(flat).reshape(t, c)


def pt_step(target, state: PTState, beta: torch.Tensor,
            sigma_l: torch.Tensor, noises, us, u_swap) -> PTState:
    """One PT step from explicit draws (``ops/tempering.py:262-326`` of
    the JAX package, operation for operation): ``beta [T]`` float32,
    ``sigma_l [T, D or 1, 1]`` the per-rung proposal scale, ``noises``
    ``n_inner`` normals ``[T, D, C]``, ``us`` as many accept uniforms
    ``[T, C]``, ``u_swap [T-1, C]``."""
    positions, raw_logp = state.positions, state.raw_logp
    for noise, u in zip(noises, us):
        proposed = positions + sigma_l * noise
        prop_lp = rung_logp(target, proposed)
        accept = beta[:, None] * (prop_lp - raw_logp) > torch.log(u)
        positions = torch.where(accept[:, None, :], proposed, positions)
        raw_logp = torch.where(accept, prop_lp, raw_logp)

    n_pairs = beta.shape[0] - 1
    active = (torch.arange(n_pairs, device=beta.device) % 2
              == state.parity % 2)[:, None]  # [T-1, 1]
    delta_beta = beta[:-1] - beta[1:]
    log_acc = delta_beta[:, None] * (raw_logp[1:] - raw_logp[:-1])
    swap = active & (log_acc > torch.log(u_swap))  # [T-1, C]
    no = torch.zeros_like(swap[:1])
    lower = torch.cat([swap, no])  # rung t takes rung t+1's state
    upper = torch.cat([no, swap])  # rung t takes rung t-1's state
    positions = torch.where(
        lower[:, None, :], _shift_up(positions),
        torch.where(upper[:, None, :], _shift_down(positions), positions))
    raw_logp = torch.where(lower, _shift_up(raw_logp),
                           torch.where(upper, _shift_down(raw_logp),
                                       raw_logp))
    swap_accept = torch.where(
        active,
        (1.0 - SWAP_EWMA_ALPHA) * state.swap_accept
        + SWAP_EWMA_ALPHA * swap.to(state.swap_accept.dtype),
        state.swap_accept)
    return PTState(positions, raw_logp, (state.parity + 1) % 2, swap_accept)


def tempering_kernel(target, betas: Sequence[float], *, proposal_std=1.0,
                     n_inner: int = 1, steps_per_call: int = 1,
                     use_pallas=False):
    """Build ``(init_fn, step_fn)`` for replica-exchange random-walk MH.

    ``init_fn(positions [C, D], state=None) -> PTState`` copies the cold
    positions to every rung (``state``: the ``StateGroup`` of a rank's
    D-slice); ``step_fn(state, key: StepKey) -> PTState`` is one step.
    ``step_fn.block_fn(state, key, out=None) -> state`` runs K =
    ``steps_per_call`` steps (``step_fn.block_size``), writing the cold
    rung of each into ``out[i]`` of a ``[K, C, D]`` view: with
    ``use_pallas="full"`` one launch of Kernel 8 (``kernels/pt_full.py``;
    on CUDA tensors the target needs an instantiated ``cuda_functor``,
    ``_build.PT_INSTANCES``), else K plain steps.
    """
    betas = tuple(float(b) for b in betas)
    if len(betas) < 2:
        raise ValueError("betas must have >= 2 temperatures "
                         f"(got {betas!r}); tempering with one replica "
                         "is plain MH")
    if abs(betas[0] - 1.0) > 1e-12:
        raise ValueError(f"betas[0] must be 1.0 (the cold chain), "
                         f"got {betas[0]}")
    if any(b2 >= b1 for b1, b2 in zip(betas, betas[1:])) or betas[-1] <= 0:
        raise ValueError("betas must be strictly decreasing and positive, "
                         f"got {betas!r}")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if use_pallas not in (False, "full"):
        raise ValueError(
            "tempering has no trajectory to fuse separately: the only fused "
            f'variant is use_pallas="full"; got {use_pallas!r}')
    t_count, k = len(betas), steps_per_call
    ladders = {}  # the Ladder per (device, D, first column)

    def _ladder(positions, st=None):  # [T, D, C]
        """The ladder; under a split ``st`` built at the global D, its
        ``sigma_l`` narrowed to the rank's columns."""
        d0 = st.d0 if split(st) else None
        key = (positions.device, positions.shape[1], d0)
        if key not in ladders:
            d = positions.shape[1]
            lad = make_ladder(betas, proposal_std,
                              d if d0 is None else st.n_dim, positions.device)
            if d0 is not None and lad.sigma_l.shape[1] > 1:
                lad = lad._replace(sigma_l=lad.sigma_l.narrow(1, d0, d))
            ladders[key] = lad
        return ladders[key]

    def init_fn(positions: torch.Tensor, state=None) -> PTState:
        tgt = SliceTarget(target, state) if split(state) else target
        lp = tgt.batch_logp(positions)
        return PTState(
            positions.T.unsqueeze(0).repeat(t_count, 1, 1).contiguous(),
            lp.unsqueeze(0).repeat(t_count, 1).contiguous(), 0,
            torch.zeros((t_count - 1, positions.shape[0]),
                        dtype=torch.float32, device=positions.device))

    def plain_step(state: PTState, key: StepKey) -> PTState:
        st = key.state
        lad = _ladder(state.positions, st)
        gen, pos = key.generator, state.positions
        f = dict(generator=gen, dtype=state.raw_logp.dtype, device=pos.device)

        def rand(shape):  # [..., C]: a shard's chains of the global draw
            return chain_draw(key.chains, lambda s: torch.rand(s, **f),
                              shape, len(shape) - 1)

        noises, us = [], []
        for _ in range(n_inner):
            noises.append(state_draw(key.chains, st, lambda s: torch.randn(
                s, generator=gen, dtype=pos.dtype, device=pos.device),
                pos.shape, 2, 1))
            us.append(rand(state.raw_logp.shape))
        u_swap = rand(state.swap_accept.shape)
        return pt_step(SliceTarget(target, st) if split(st) else target,
                       state, lad.beta, lad.sigma_l, noises, us, u_swap)

    def fused(state: PTState, key: StepKey, k_steps: int, out=None):
        pos, lp, sa = pt_multistep(
            target, state.positions, state.raw_logp, state.swap_accept,
            state.parity, _ladder(state.positions), key.seed, key.step,
            k_steps, n_inner, out, chain0=chain0(key))
        return PTState(pos, lp, (state.parity + k_steps) % 2, sa)

    if use_pallas:

        def step_fn(state: PTState, key: StepKey) -> PTState:
            return fused(state, key, 1)

        def block_fn(state: PTState, key: StepKey, out=None) -> PTState:
            return fused(state, key, k, out)
    else:
        step_fn = plain_step

        def block_fn(state: PTState, key: StepKey, out=None) -> PTState:
            # the cold rung only, in the [C, D] layout, step by step
            for i in range(k):
                state = plain_step(state, key._replace(step=key.step + i))
                if out is not None:
                    out[i].copy_(state.positions[0].T)
            return state

    step_fn.block_fn = block_fn
    step_fn.block_size = k
    return init_fn, step_fn
