"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Counterpart of ``mini_mcmc_tpu/ops/ensemble.py``. The ``[C, D]`` batch
holds ``C / W`` independent ensembles of ``W`` walkers; each ensemble's
walkers split into two fixed halves, and a sweep moves every walker of
the first half against a random partner from the second, then every
walker of the second half against the UPDATED first half:

    y_i = x_j + z (x_i - x_j),   z = ((a - 1) u + 1)^2 / a  (g(z) ~ 1/sqrt z),
    accept iff (D - 1) ln z + logp(y_i) - logp(x_i) > ln u'.

Two batched target evaluations a sweep, no per-walker loop, and no kernel:
the JAX package runs this in XLA. :func:`ensemble_sweep` takes the sweep's
draws as inputs (partner indices, the z and accept uniforms of each
half), so a test can hand it the JAX package's own; the sampler draws
them from ``key.generator`` on the positions' device.

Under a state split (``key.state``: D split over a ``"state"`` axis) each
rank moves its D-slice of every walker: the partner gather and the
stretch are elementwise on its columns, the draws are per walker and the
same on every state rank, the stretch's ``(D - 1) ln z`` takes the global
D, and the log density runs on a DTensor view of the slice
(``parallel.mesh.SliceTarget``), its sum over D whole on every rank: one
all-reduce a half, two a sweep. Every shard of a walker then takes the
same accept decision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.collectives import chain_draw, split
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, make_scan_block_fn


class EnsembleState(NamedTuple):
    positions: torch.Tensor  # [C, D], C = n_ensembles * walkers_per_ensemble
    logp: torch.Tensor  # [C] cached target log density


class HalfDraws(NamedTuple):
    """One half-update's draws, each ``[E, W / 2]``."""

    partner: torch.Tensor  # int64 index into the other half
    u_z: torch.Tensor  # the stretch's uniform
    u_accept: torch.Tensor  # the accept's uniform


def half_draws(gen: torch.Generator, e: int, h: int,
               like: torch.Tensor, ensembles=None) -> HalfDraws:
    """A half-update's draws from ``gen``, on ``like``'s device: under
    ``ensembles`` (a ChainGroup counted in ensembles) a shard's rows of the
    global draws."""
    shape, dev = (e, h), like.device
    return HalfDraws(
        chain_draw(ensembles, lambda s: torch.randint(
            0, h, s, generator=gen, device=dev), shape),
        chain_draw(ensembles, lambda s: torch.rand(
            s, generator=gen, dtype=like.dtype, device=dev), shape),
        chain_draw(ensembles, lambda s: torch.rand(
            s, generator=gen, dtype=like.dtype, device=dev), shape))


def _half_update(target, active, active_lp, other, draws: HalfDraws,
                 a: float, n_dim: int | None = None):
    """Move ``active`` ``[E, h, D]`` against partners from ``other``
    (``ensemble.py:110-127``); returns the kept positions and logp.
    ``n_dim``: the state's D when ``active`` holds a D-slice of it."""
    e, h, d = active.shape
    idx = draws.partner[:, :, None].expand(e, h, d)
    partners = torch.gather(other, 1, idx)
    z = ((a - 1.0) * draws.u_z + 1.0) ** 2 / a
    proposed = partners + z[:, :, None] * (active - partners)
    prop_lp = target.batch_logp(proposed.reshape(e * h, d)).reshape(e, h)
    n = d if n_dim is None else n_dim
    log_accept = (n - 1.0) * torch.log(z) + prop_lp - active_lp
    accept = log_accept > torch.log(draws.u_accept)  # strict
    return (torch.where(accept[:, :, None], proposed, active),
            torch.where(accept, prop_lp, active_lp))


def ensemble_sweep(target, state: EnsembleState, walkers_per_ensemble: int,
                   a: float, first: HalfDraws, second: HalfDraws,
                   n_dim: int | None = None) -> EnsembleState:
    """One full sweep on given draws (``ensemble.py:129-145``): the first
    half of every ensemble against the second, then the second against
    the updated first. ``n_dim``: the state's D when the positions hold a
    D-slice of it (``target`` then a ``SliceTarget``)."""
    c, d = state.positions.shape
    w = walkers_per_ensemble
    e, half = c // w, w // 2
    pos = state.positions.reshape(e, w, d)
    lp = state.logp.reshape(e, w)
    pos1, lp1 = _half_update(target, pos[:, :half], lp[:, :half],
                             pos[:, half:], first, a, n_dim)
    pos2, lp2 = _half_update(target, pos[:, half:], lp[:, half:], pos1,
                             second, a, n_dim)
    return EnsembleState(torch.cat([pos1, pos2], dim=1).reshape(c, d),
                         torch.cat([lp1, lp2], dim=1).reshape(c))


def ensemble_kernel(target, *, walkers_per_ensemble: int, a: float = 2.0,
                    steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for the batched stretch move.

    ``init_fn(positions [C, D], state=None) -> EnsembleState``: ``C`` a
    multiple of ``walkers_per_ensemble``, which must be even, >= 4 and >=
    D + 2 (fewer walkers confine the move to a proper affine subspace);
    use >= 2 D. ``state``: the ``StateGroup`` of a rank's D-slice.
    ``step_fn(state, key) -> EnsembleState`` is one sweep; partners never
    cross an ensemble's boundary. ``a`` > 1 is the stretch scale;
    ``steps_per_call`` > 1 attaches the K-sweep ``block_fn``.
    """
    w = walkers_per_ensemble
    if w < 4 or w % 2 != 0:
        raise ValueError(
            f"walkers_per_ensemble must be even and >= 4, got {w}")
    if not a > 1.0:
        raise ValueError(f"stretch scale a must be > 1, got {a}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    half = w // 2

    def init_fn(positions: torch.Tensor, state=None) -> EnsembleState:
        c, d = positions.shape
        tgt = target
        if split(state):
            tgt, d = SliceTarget(target, state), state.n_dim
        if c % w != 0:
            raise ValueError(f"n_chains={c} must be a multiple of "
                             f"walkers_per_ensemble={w}")
        if w < d + 2:
            # the stretch move never leaves the ensemble's affine hull, so
            # a small ensemble on a high-D target is silently non-ergodic
            raise ValueError(
                f"walkers_per_ensemble={w} cannot ergodically sample a "
                f"{d}-D target: the stretch move is confined to the "
                f"ensemble's affine hull (dim <= {w - 1}); need at least "
                f"D+2 = {d + 2} walkers per ensemble, ideally >= 2*D")
        return EnsembleState(positions, tgt.batch_logp(positions))

    def step_fn(state: EnsembleState, key: StepKey) -> EnsembleState:
        e = state.positions.shape[0] // w
        gen, like = key.generator, state.positions
        # a shard holds whole ensembles (EnsembleSampler checks it)
        ens = (None if key.chains is None else key.chains._replace(
            chain0=key.chains.chain0 // w, n_chains=key.chains.n_chains // w))
        first = half_draws(gen, e, half, like, ens)
        second = half_draws(gen, e, half, like, ens)
        st = key.state
        if split(st):
            return ensemble_sweep(SliceTarget(target, st), state, w, a, first,
                                  second, st.n_dim)
        return ensemble_sweep(target, state, w, a, first, second)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
