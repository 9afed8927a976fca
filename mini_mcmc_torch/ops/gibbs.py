"""Batched Gibbs sweep kernel (counterpart of
``mini_mcmc_tpu/ops/gibbs.py``).

One step is a full coordinate sweep, ``state[:, i] = conditional(gen, i,
state)`` for ``i = 0..D-1`` (reference ``GibbsMarkovChain::step``,
``gibbs.rs:95-99``), batched over chains. The sweep is sequential:
coordinate ``i`` conditions on the state already updated at coordinates
``< i``.

Randomness: the plain tier draws from ``key.generator``; the fused tier
(``use_pallas="full"``) draws from the Philox stream at ``(key.seed,
chain, key.step, i)`` inside Kernel 6 (``kernels/gibbs_full.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.collectives import chain_call
from ..runner import StepKey, chain0, make_scan_block_fn
from .kernels.gibbs_full import gibbs_multistep, sample_form


class GibbsState(NamedTuple):
    positions: torch.Tensor  # [C, D]


def gibbs_kernel(conditional, *, use_pallas=False, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for a batched Gibbs sweep.

    ``init_fn(positions [C, D]) -> GibbsState``;
    ``step_fn(state, key: StepKey) -> GibbsState``.

    ``use_pallas="full"`` runs whole sweeps in Kernel 6: it needs a
    conditional with a fused form, built in (``Conditional.cuda_functor``)
    or the user's (``sample_words`` and ``cuda_words``, the twin's, with
    ``cuda_source`` on CUDA positions: ``ops/gibbs.py:57-60`` in the JAX
    package requires ``sample_dc`` likewise), and on CUDA positions an
    instantiated D, which the kernel reads from their shape (the JAX
    package's ``n_dim`` has no counterpart).
    ``steps_per_call`` > 1 attaches ``step_fn.block_fn``/``block_size``
    as in :func:`~.mh.mh_kernel`.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    full = False
    if use_pallas:
        if use_pallas != "full":
            raise ValueError(
                "Gibbs has no trajectory to fuse separately: the only fused "
                f'variant is use_pallas="full"; got {use_pallas!r}')
        sample_form(conditional)  # raises without a fused form
        full = True

    def init_fn(positions: torch.Tensor) -> GibbsState:
        return GibbsState(positions)

    def step_fn(state: GibbsState, key: StepKey) -> GibbsState:
        if full:
            return GibbsState(gibbs_multistep(conditional, state.positions,
                                              key.seed, key.step, 1,
                                              chain0=chain0(key)))
        positions = state.positions.clone()
        for i in range(positions.shape[1]):
            # a shard samples from the global shape's draws
            positions[:, i] = chain_call(
                key.chains,
                lambda x, i=i: conditional.sample(key.generator, i, x),
                positions)
        return GibbsState(positions)

    if steps_per_call > 1:
        k = steps_per_call
        if full:

            def block_fn(state: GibbsState, key: StepKey, out=None):
                return GibbsState(gibbs_multistep(
                    conditional, state.positions, key.seed, key.step, k,
                    out, chain0=chain0(key)))
        else:
            block_fn = make_scan_block_fn(step_fn, k)
        step_fn.block_fn = block_fn
        step_fn.block_size = k

    return init_fn, step_fn
