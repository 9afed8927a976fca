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
        cuda_affine: the kernels run ``cuda_functor`` inside the affine
            wrapper of a whitened target (``csrc/targets.cuh:Whitened``,
            set by ``models.precondition.precondition_target``): then, at
            D <= ``precondition.AFFINE_MAX_DIM``, ``cuda_params`` starts
            with the lower triangle of ``L``, row by row, ``D (D + 1) / 2``
            floats, before the functor's own.
        cuda_scaled: a target whitened once by a diagonal metric: the
            separable kernel runs ``cuda_functor`` at ``x = s * y``, ``s``
            the last ``sep_form`` table (``csrc/coord_targets.cuh:Scaled``);
            over a transformed target the scale multiplies ``y = s z``
            ahead of the bijectors (``coord_targets.cuh:TransformedCoord``).
        cuda_transform: the kernels run ``cuda_functor`` at ``x = g(y)``
            with the log-Jacobian added (``csrc/targets.cuh:Transformed``,
            set by ``models.transforms.CoordinateTransform.wrap``): each
            coordinate's ``(code, offset, width)``, ``None`` for an
            untransformed target. At D <= 4 ``cuda_params`` carry the
            bijector table (``transforms.transform_params``) ahead of the
            functor's own, after a whitened target's triangle of ``L``.
        cuda_unsupported: why the kernels cannot run this target although
            it may name a functor (a transform with a custom bijector, or
            one around a whitened or transformed target), or ``None``; the
            fused tiers raise with it on CUDA.
        sep_form: optional coordinate-sliced form for the separable HMC
            tier (``use_pallas="separable"``): ``(tile_logp, tables)``,
            each table a ``[D]`` or ``[1, D]`` tensor of per-coordinate
            parameters, ``tile_logp(x [C', d'], *tables each [1, d']) ->
            [C']`` the density of that coordinate slice. ``None`` means
            the batch form, valid for slice-agnostic densities.
            :func:`validate_separable` checks it at sampler construction.
            On CUDA tensors the tier's kernel evaluates the coordinate
            functor named by ``cuda_functor`` (``csrc/coord_targets.cuh``)
            on the same tables instead.
    """

    logp: Callable
    logp_batch: Optional[Callable] = None
    grad: Optional[Callable] = None
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()
    cuda_affine: bool = False
    cuda_scaled: bool = False
    cuda_transform: Optional[tuple] = None
    cuda_unsupported: Optional[str] = None
    logp_normalized: Optional[Callable] = None
    sep_form: Optional[tuple] = None

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

    def sep_forms(self):
        """``(tile_logp, tables)`` for the separable HMC tier, the tables
        normalized to ``[1, D]`` tensors (``base.py:127-149`` in the JAX
        package). Without a ``sep_form`` it is the batch form and no
        table."""
        if self.sep_form is not None:
            fn, tables = self.sep_form
            return fn, tuple(_norm_sep_table(t) for t in tables)
        return (lambda x, _f=self.batch_logp: _f(x)), ()


def _norm_sep_table(t) -> torch.Tensor:
    """A ``sep_form`` table as ``[1, D]``; anything but ``[D]`` or
    ``[1, D]`` raises by its actual shape (a ``[2, D/2]`` table has the
    right size and would corrupt the slicing)."""
    t = torch.as_tensor(t)
    if t.dim() == 1:
        return t.reshape(1, -1)
    if t.dim() == 2 and t.shape[0] == 1:
        return t
    raise ValueError("sep_form coordinate tables must be [D] or [1, D] "
                     f"arrays; got shape {tuple(t.shape)}")


_SEP_MSG = (
    "The separable HMC tier (use_pallas='separable') evaluates the density "
    "one coordinate at a time and would sample a WRONG (product-"
    "approximation) posterior. Use use_pallas=False, True or 'full'."
)


def _sep_part(tile_logp, x, tables, what: str) -> torch.Tensor:
    """``tile_logp`` on a slice; a failure (a fixed-D form that rejects the
    narrowed slice) raises the separability error, naming the cause."""
    try:
        return tile_logp(x, *tables)
    except (RuntimeError, IndexError, ValueError, TypeError) as e:
        raise ValueError(
            f"target is not coordinate-separable: the tile density failed "
            f"on {what} ({type(e).__name__}: {e}). " + _SEP_MSG) from e


def validate_separable(target: Target, positions, *, rtol: float = 3e-4,
                       atol: float = 1e-4, max_rows: int = 64) -> None:
    """Raise ``ValueError`` unless ``target``'s density is the sum of its
    ``sep_form`` over coordinate partitions, on (up to ``max_rows`` of) the
    actual ``positions`` (``base.py:348-436`` in the JAX package).

    Two partitions are checked: the contract's three contiguous chunks,
    and the one the tier's kernel uses, single coordinates (its coordinate
    functor is elementwise by construction; the D-tiles it sums partials
    over are unions of coordinates, so they pass whenever single
    coordinates do). The single-coordinate sums come from one
    ``torch.func.vmap`` over the coordinates, each call seeing a
    ``[R, 1]`` slice and ``[1, 1]`` tables. The probe runs where the
    positions lie (a density may close over tensors on that device), its
    sums in float64. No keyword turns it off.
    """
    x = torch.as_tensor(positions).detach()[:max_rows]
    if x.dim() != 2:
        raise ValueError("positions must be [n_chains, D]; got shape "
                         f"{tuple(x.shape)}")
    r, d = x.shape
    if d < 2:
        return  # one coordinate is trivially separable
    tile_logp, tables = target.sep_forms()
    tables = tuple(t.detach().to(x.device, x.dtype) for t in tables)
    for t in tables:
        if t.shape[1] != d:
            raise ValueError(f"sep_form coordinate tables must cover all "
                             f"D={d} coordinates; got a [1, {t.shape[1]}] "
                             "table")
    want = target.batch_logp(x).double()
    cuts = sorted({d // 3, 2 * d // 3, d} - {0})
    lo, chunks = 0, torch.zeros_like(want)
    for hi in cuts:
        part = _sep_part(tile_logp, x[:, lo:hi],
                         tuple(t[:, lo:hi] for t in tables),
                         f"a [{r}, {hi - lo}] coordinate slice")
        chunks = chunks + part.double()
        lo = hi
    singles = _sep_part(
        torch.func.vmap(lambda xc, *tc: tile_logp(xc, *tc)),
        x.T.reshape(d, r, 1), tuple(t.T.reshape(d, 1, 1) for t in tables),
        f"single [{r}, 1] coordinates")
    for got, what in ((chunks, f"coordinate chunks (cuts at {cuts})"),
                      (singles.double().sum(dim=0), "single coordinates")):
        # np.isclose with the atol scaled to max(|want|, 1), as in JAX
        close = ((got - want).abs()
                 <= atol * want.abs().clamp(min=1.0) + rtol * want.abs())
        close |= torch.isneginf(want) & torch.isneginf(got)
        if not bool(close.all()):
            err = float((got - want).abs().nan_to_num(nan=float("inf")).max())
            raise ValueError(
                f"target is not coordinate-separable: logp over {what} does "
                f"not sum to the full logp (max abs err {err:.3g}). "
                + _SEP_MSG)


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
