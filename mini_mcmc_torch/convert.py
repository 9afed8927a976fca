"""Carry chain state and sampler configuration across from the JAX package.

The Rosenbrock model has no weights: what carries over is the chain state
(positions and their cached logp and gradient) and the sampler's
configuration. Everything crosses as numpy arrays, so this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hmc import HMCState

#: JAX ``HMC`` constructor keywords with no counterpart in the port
_JAX_ONLY = ("unroll", "pallas_interpret", "validate_dc")


def hmc_state_from_numpy(positions, logp, grad, device=None) -> HMCState:
    """An ``HMCState`` of float32 tensors on ``device`` from numpy arrays
    (e.g. ``np.asarray`` of a JAX sampler's ``.state`` fields)."""

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return HMCState(t(positions), t(logp), t(grad))


def state_to_numpy(state: HMCState):
    """``(positions, logp, grad)`` as numpy arrays."""
    return tuple(np.asarray(x.detach().cpu()) for x in state)


def sampler_kwargs(jax_hmc) -> dict:
    """The port's ``HMC`` keyword arguments read from a JAX ``HMC``'s
    recorded constructor arguments (``_ctor``). Raises for a metric or a
    transform, which the port does not have yet."""
    ctor = dict(jax_hmc._ctor)
    if getattr(jax_hmc, "metric", None) is not None:
        raise ValueError("HMC(metric=...) is not ported yet")
    if ctor.pop("transform", None) is not None:
        raise ValueError("HMC(transform=...) is not ported yet")
    for name in _JAX_ONLY:
        ctor.pop(name, None)
    return ctor
