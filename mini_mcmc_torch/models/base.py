"""The ``Target``, ``Proposal`` and ``Conditional`` abstractions, in PyTorch.

Counterpart of ``mini_mcmc_tpu/models/base.py:30-95,439-494``. Densities
are plain functions on tensors. ``logp`` and ``grad`` act on the trailing
axis of a ``[..., D]`` tensor, so a ``[C, D]`` batch goes through them as
it is (the
JAX package maps a per-state function with ``vmap``; broadcasting is the
PyTorch idiom for the same thing). Without an analytic ``grad`` the
gradient comes from autograd.

There are no ``*_dc`` forms: the ``[D, C]`` chains-on-lanes layout exists
for the TPU's compiler. The hand-written CUDA kernels cannot run a Python
density; a target they can run names its built-in device functor in
``cuda_functor`` (``csrc/targets.cuh``), and so does a proposal
(``csrc/proposals.cuh``) or a Gibbs conditional (``csrc/conditionals.cuh``).
Random draws outside the kernels come from a ``torch.Generator`` on the
positions' device, passed as ``gen``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Target:
    """An unnormalized target density.

    Attributes:
        logp: ``[..., D] -> [...]`` unnormalized log density.
        logp_normalized: optional normalized log density, same form.
        logp_batch: optional ``[C, D] -> [C]`` override of ``logp`` for
            batches (e.g. a form written for speed).
        grad: optional analytic gradient ``[..., D] -> [..., D]``; autograd
            of the batch log density otherwise.
        cuda_functor: name of the built-in CUDA density that the
            hand-written kernels evaluate for this target (e.g.
            ``"rosenbrock_nd"``), or ``None`` when there is none.
        cuda_params: the functor's coefficients, a tuple of floats handed
            to the kernels as a ``const float*`` (e.g. the Gaussian's mean,
            inverse covariance and normalizing constant); empty when the
            functor has none.
    """

    logp: Callable
    logp_batch: Optional[Callable] = None
    grad: Optional[Callable] = None
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()
    logp_normalized: Optional[Callable] = None

    def batch_logp(self, positions: torch.Tensor) -> torch.Tensor:
        """Log density for a ``[C, D]`` batch of positions -> ``[C]``."""
        if self.logp_batch is not None:
            return self.logp_batch(positions)
        return self.logp(positions)

    def batch_grad(self, positions: torch.Tensor) -> torch.Tensor:
        """Gradient for a ``[C, D]`` batch -> ``[C, D]``."""
        if self.grad is not None:
            return self.grad(positions)
        return self.batch_logp_and_grad(positions)[1]

    def batch_logp_and_grad(self, positions: torch.Tensor):
        """Value and gradient for a ``[C, D]`` batch -> (``[C]``,
        ``[C, D]``)."""
        if self.grad is not None:
            return self.batch_logp(positions), self.grad(positions)
        # rows are independent, so the gradient of the sum is per row
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            vals = self.batch_logp(x)
            (grads,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), grads


@dataclasses.dataclass(frozen=True, eq=False)
class Proposal:
    """A proposal kernel q(x' | x) for Metropolis-Hastings.

    Attributes:
        sample: ``(gen, current [..., D]) -> proposed [..., D]``, drawing
            from the ``torch.Generator`` ``gen``; one form serves one
            chain and a ``[C, D]`` batch.
        logp: ``(from [..., D], to [..., D]) -> [...]`` log q(to | from).
        symmetric: whether ``logp(a, b) == logp(b, a)``; the fused kernel
            needs it (it skips the q terms of the accept ratio, which
            cancel).
        scaled: optional ``(factor) -> Proposal``, this proposal with its
            length scale multiplied by ``factor``.
        cuda_functor: name of the built-in CUDA form that the MH kernel
            draws this proposal with (``csrc/proposals.cuh``), or ``None``.
        cuda_params: that form's coefficients (floats).
    """

    sample: Callable
    logp: Callable
    symmetric: bool = False
    scaled: Optional[Callable] = None
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()


@dataclasses.dataclass(frozen=True, eq=False)
class Conditional:
    """Full conditionals for Gibbs (reference ``Conditional<S>``).

    Attributes:
        sample: ``(gen, index, states [C, D]) -> [C]`` draws coordinate
            ``index`` (a Python int) of every chain from its full
            conditional given the complete state.
        cuda_functor: name of the built-in CUDA form that the Gibbs kernel
            runs (``csrc/conditionals.cuh``), or ``None``.
        cuda_params: that form's coefficients (floats).
    """

    sample: Callable
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()
