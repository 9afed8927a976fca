"""Whitening preconditioner: a metric for HMC and NUTS as a coordinate map.

Counterpart of ``mini_mcmc_tpu/models/precondition.py``. Unit-metric
HMC/NUTS on the whitened target ``logp_y(y) = logp_x(L y)`` is HMC/NUTS
with mass matrix ``M = (L L^T)^-1`` on the original target (Neal 2011,
sec. 4.1); samples map back as ``x = L y``. The samplers keep their state
in y and record x (``runner.py``'s ``positions_of``), never a second cube.

The estimator takes one cross-chain moment snapshot of a ``[C, D]``
ensemble, the lockstep analog of Stan's warm-up covariance windows:

    nuts.run(2048, 128)                            # adapt, equilibrate
    tuned = nuts.reconditioned("dense")            # estimate and whiten

On the card the hand-written kernels run the whitened target through one
affine wrapper around the inner target's CUDA form
(``csrc/targets.cuh:Whitened``): :func:`precondition_target` keeps the
inner ``cuda_functor`` or ``cuda_source`` (or, for a Python density, the
target the kernels trace, ``cuda_base``), prepends the lower triangle of
``L`` to its ``cuda_params`` and sets ``cuda_affine``. A diagonal metric
goes in as ``L = diag(scale)`` at D <= 4, where the built-in functors'
instances are, and above it as its D scales (``cuda_diag``,
``csrc/targets.cuh:WhitenedDiag``, the JAX package's diag branch of
``_wrap_dc_forms``). The metric rides in ``cuda_params`` only at the D
where Kernels 1-4 run the target (``_build.kernel_dims``: 4 for a
built-in functor, 16 for a user density, the JAX package's
``_DENSE_DC_MAX_DIM``): above it the triangle (D (D + 1) / 2 floats)
would cost quadratic host time and memory for nothing, and a diagonal
metric reaches the separable kernel as one more coordinate table
(``csrc/coord_targets.cuh:Scaled``, ``Target.cuda_scaled``).

On a state whose D is split over a ``"state"`` axis
(``parallel.chain_state_mesh``) a diagonal metric acts coordinate by
coordinate: the whitened target runs on a DTensor view of a rank's D-slice
(``parallel.mesh.SliceTarget``), where the scale is narrowed to the slice,
and the row maps use :meth:`Preconditioner.at_slice`. An estimate on such
a state (:func:`estimate_preconditioner` with ``state=``) keeps each
rank's slice of the scale, a DTensor sharded over the axis. A dense metric
couples the coordinates and does not take a split D.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kernels._build import DIAG_TRIANGLE_MAX_DIM, kernel_dims
from ..parallel.collectives import all_reduce, split, state_sum
from .base import Target, cuda_base_of


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


@dataclasses.dataclass(frozen=True, eq=False)
class Preconditioner:
    """An affine whitening map ``x = L y`` (``y = L^-1 x``).

    ``kind``: ``"diag"`` (``L = diag(scale)``, ``scale`` ``[D]``) or
    ``"dense"`` (``chol`` ``[D, D]`` lower triangular, e.g. the Cholesky
    factor of the estimated target covariance). The maps act on the
    trailing axis of ``[..., D]`` tensors and return the argument's dtype.
    """

    kind: str
    scale: torch.Tensor | None = None  # [D], kind == "diag"
    chol: torch.Tensor | None = None  # [D, D] lower-tri, kind == "dense"

    def __post_init__(self):
        if self.kind not in ("diag", "dense"):
            raise ValueError(
                f"kind must be 'diag' or 'dense', got {self.kind!r}")
        arr = self.scale if self.kind == "diag" else self.chol
        want = 1 if self.kind == "diag" else 2
        if arr is None or getattr(arr, "ndim", None) != want:
            raise ValueError(
                f"kind={self.kind!r} needs a {want}-D "
                f"{'scale' if want == 1 else 'chol'} tensor; got "
                f"{type(arr).__name__}")

    @property
    def matrix(self) -> torch.Tensor:
        """``L`` itself: ``chol``, or ``diag(scale)`` (``D x D``: build it
        at small D only)."""
        return self.chol if self.kind == "dense" else torch.diag(self.scale)

    @property
    def dim(self) -> int:
        arr = self.scale if self.kind == "diag" else self.chol
        return arr.shape[0]

    def to(self, device) -> "Preconditioner":
        """This map with its tensor on ``device``."""
        if self.kind == "diag":
            return dataclasses.replace(self, scale=self.scale.to(device))
        return dataclasses.replace(self, chol=self.chol.to(device))

    def sigma_min(self) -> float:
        """Smallest singular value of ``L``, the stiffest direction's
        width: ``eps_y = eps_x / sigma_min`` keeps a tuned step size's
        stability margin in whitened coordinates. A host float, so that
        ``reconditioned`` stays deterministic; a scale split over a state
        axis takes its minimum over the axis (one scalar all-reduce)."""
        if self.kind == "diag" and _is_dtensor(self.scale):
            m = torch.min(torch.abs(self.scale.to_local())).reshape(1)
            return float(all_reduce(m, self.scale.device_mesh.get_group(),
                                    "min")[0])
        if self.kind == "diag":
            return float(np.min(np.abs(self.scale.detach().cpu().numpy())))
        return float(np.linalg.svd(self.chol.detach().cpu().numpy(),
                                   compute_uv=False)[-1])

    def at_slice(self, state) -> "Preconditioner":
        """The map of a rank's D-slice of a split state (``state``, a
        :class:`~mini_mcmc_torch.parallel.collectives.StateGroup`): a
        diagonal metric with its scale narrowed to the slice (the rank's
        own part of a scale that is itself split). A dense metric couples
        the coordinates and raises ``ValueError``."""
        if self.kind != "diag":
            raise ValueError(
                "a dense metric couples every coordinate and does not run "
                "on a state split over a 'state' axis (shard_state_dim="
                "True); use a diagonal metric (kind='diag')")
        if _is_dtensor(self.scale):
            return dataclasses.replace(self, scale=self.scale.to_local())
        d = state.n_dim // state.size
        return dataclasses.replace(self,
                                   scale=self.scale.narrow(0, state.d0, d))

    def _on(self, like: torch.Tensor) -> torch.Tensor:
        arr = self.scale if self.kind == "diag" else self.chol
        return arr.to(device=like.device, dtype=like.dtype)

    def to_x(self, y: torch.Tensor) -> torch.Tensor:
        """Un-whiten: ``[..., D]`` y-coordinates -> x-coordinates. Dense:
        ``x_i = sum_j L_ij y_j`` as a broadcast product and a sum over
        ``j``: on the card the ``[C, 2] @ [2, 2]`` product of a recorded
        row went to a 44.7 µs GEMM tile kernel (NVIDIA H100, PERF.md)."""
        if self.kind == "diag":
            return y * self._on(y)
        return (y.unsqueeze(-2) * self._on(y)).sum(-1)

    def to_y(self, x: torch.Tensor) -> torch.Tensor:
        """Whiten: ``[..., D]`` x-coordinates -> y-coordinates (a
        triangular solve ``L y = x`` for each row)."""
        if self.kind == "diag":
            return x / self._on(x)
        flat = x.reshape(-1, x.shape[-1])
        sol = torch.linalg.solve_triangular(self._on(x), flat.T,
                                            upper=False).T
        return sol.reshape(x.shape)

    def grad_to_y(self, g: torch.Tensor) -> torch.Tensor:
        """Chain rule: an x-space gradient ``[..., D]`` -> y-space
        (``g_y = L^T g_x``)."""
        if self.kind == "diag":
            return g * self._on(g)
        return g @ self._on(g)

    def logdet(self) -> torch.Tensor:
        """``log |det L|``, the shift of the whitened normalized density
        (``p_y(y) = p_x(L y) |det L|``)."""
        d = self.scale if self.kind == "diag" else torch.diagonal(self.chol)
        return torch.sum(torch.log(d))


def estimate_preconditioner(positions, kind: str = "diag", *,
                            reg: float = 1e-8,
                            state=None) -> Preconditioner:
    """Estimate a whitening map from a ``[C, D]`` chain ensemble.

    One cross-chain moment snapshot: the ``ddof=1`` variance (diag), or the
    covariance ``delta^T delta / (C - 1)`` and its Cholesky factor (dense),
    both ridged by ``reg * mean(var) + 1e-30`` so that a degenerate
    ensemble stays invertible. Computed where the positions lie, in their
    dtype promoted to at least float32 (the JAX package picks float64 under
    ``jax_enable_x64``; the port has no such switch).

    ``state``: the :class:`~mini_mcmc_torch.parallel.collectives.
    StateGroup` of a split D, ``positions`` then every chain's slice on
    this rank. The variance is per coordinate, so each rank estimates its
    slice; the ridge's mean over D crosses the axis (one scalar
    all-reduce), and the scale comes back as a DTensor sharded over the
    axis, each rank keeping its slice. ``kind="dense"`` raises there.
    """
    if kind not in ("diag", "dense"):
        raise ValueError(f"kind must be 'diag' or 'dense', got {kind!r}")
    if split(state) and kind == "dense":
        raise ValueError(
            "a dense metric couples every coordinate and is not estimated "
            "on a state split over a 'state' axis (shard_state_dim=True); "
            "use kind='diag'")
    x = torch.as_tensor(positions).detach()
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if x.dim() != 2 or x.shape[0] < 2:
        raise ValueError(
            f"positions must be [n_chains >= 2, D]; got shape "
            f"{tuple(x.shape)}")
    var = torch.var(x, dim=0, correction=1)
    if split(state):
        from ..parallel.mesh import slice_view

        mean = state_sum(var.sum().reshape(1), state)[0] / state.n_dim
        return Preconditioner(kind="diag", scale=slice_view(
            torch.sqrt(var + (reg * mean + 1e-30)), state))
    ridge = reg * torch.mean(var) + 1e-30
    if kind == "diag":
        return Preconditioner(kind="diag", scale=torch.sqrt(var + ridge))
    delta = x - torch.mean(x, dim=0, keepdim=True)
    cov = delta.T @ delta / (x.shape[0] - 1)
    cov = cov + ridge * torch.eye(cov.shape[0], dtype=cov.dtype,
                                  device=cov.device)
    return Preconditioner(kind="dense", chol=torch.linalg.cholesky(cov))


def _lower_triangle(metric: Preconditioner) -> tuple:
    """``L``'s lower triangle row by row, ``D (D + 1) / 2`` floats: the
    head of a whitened target's ``cuda_params`` (a diagonal metric's from
    its scale, zeros off the diagonal)."""
    if metric.kind == "diag":
        s = metric.scale.detach().cpu().double().tolist()
        return tuple(s[i] if j == i else 0.0 for i in range(len(s))
                     for j in range(i + 1))
    ell = metric.chol.detach().cpu().double().numpy()
    return tuple(float(ell[i, j]) for i in range(len(ell))
                 for j in range(i + 1))


def precondition_target(target: Target, metric: Preconditioner) -> Target:
    """The whitened target ``logp_y(y) = logp_x(L y)``.

    ``logp``, ``logp_batch``, ``grad`` (``g_y = L^T g_x``, so an analytic
    x-space gradient stays analytic) and ``logp_normalized`` (plus
    ``log |det L|``: the density of y) are wrapped. A diagonal metric keeps
    coordinate separability, so ``sep_form`` gains the scale as one more
    coordinate table; dense whitening couples coordinates, and the
    separable tier's validation then rejects the target. The CUDA form is
    the inner functor inside the affine wrapper (module docstring); a
    target that is whitened already composes its two maps into one ``L``.
    ``cuda_params`` start with the metric only where Kernels 1-4 run the
    target (the inner target's params alone above it), and
    ``cuda_scaled`` marks a diagonal metric on an unwhitened target: the
    one form the separable kernel runs (the scale as its last table).

    Over a transformed target (``models/transforms.py``) the metric acts
    on the unconstrained coordinates, the JAX package's order
    (``mini_mcmc_tpu/samplers.py:85-112``): the kernels run
    ``Whitened<Transformed<T>>``, ``L``'s triangle ahead of the bijector
    table, and under ``cuda_scaled`` the separable kernel multiplies
    ``y = s z`` before the bijectors. Two ``L``s merge only when both lie
    outside the transform; a target the kernels cannot run
    (``cuda_unsupported``) keeps its ``cuda_params``.
    """
    logp_batch = grad = logp_normalized = None

    def logp(y, _f=target.logp):
        return _f(metric.to_x(y))

    if target.logp_batch is not None:
        def logp_batch(ys, _f=target.logp_batch):
            return _f(metric.to_x(ys))

    if target.grad is not None:
        def grad(y, _f=target.grad):
            return metric.grad_to_y(_f(metric.to_x(y)))

    if target.logp_normalized is not None:
        def logp_normalized(y, _f=target.logp_normalized):
            return _f(metric.to_x(y)) + metric.logdet().to(y.dtype)

    sep_form = None
    if metric.kind == "diag":
        inner_tile, inner_tabs = target.sep_forms()
        n_inner = len(inner_tabs)

        def sep_tile_logp(y, *tabs, _f=inner_tile, _n=n_inner):
            return _f(y * tabs[_n].to(y.dtype), *tabs[:_n])

        sep_form = (sep_tile_logp, tuple(inner_tabs) + (metric.scale,))

    cuda_params, d = tuple(target.cuda_params), metric.dim
    # the metric as D scales (WhitenedDiag) or a triangle of L (Whitened),
    # where Kernels 1-4 run the target (D <= 4 for a built-in functor)
    diag = metric.kind == "diag" and d > DIAG_TRIANGLE_MAX_DIM
    carried = (d <= max(kernel_dims(target))
               and target.cuda_unsupported is None
               and not _is_dtensor(metric.scale))
    if carried:
        affine = metric
        if target.cuda_affine:
            # x = L_in (L_out y): one L_in @ L_out, diagonal if both are
            n_in = d if target.cuda_diag else d * (d + 1) // 2
            ell_in = np.zeros((d, d))
            if target.cuda_diag:
                ell_in[np.diag_indices(d)] = cuda_params[:n_in]
            else:
                ell_in[np.tril_indices(d)] = cuda_params[:n_in]
            cuda_params = cuda_params[n_in:]
            diag = diag and target.cuda_diag
            affine = Preconditioner("dense", chol=torch.from_numpy(
                ell_in @ metric.matrix.detach().cpu().double().numpy()))
        if diag:
            head = tuple(float(v) for v in np.diag(
                affine.matrix.detach().cpu().double().numpy()))
        else:
            head = _lower_triangle(affine)
        cuda_params = head + cuda_params
    return Target(
        logp=logp,
        logp_batch=logp_batch,
        grad=grad,
        cuda_functor=target.cuda_functor,
        cuda_source=target.cuda_source,
        cuda_params=cuda_params,
        cuda_coord_source=target.cuda_coord_source,
        cuda_base=cuda_base_of(target),
        cuda_affine=True,
        cuda_diag=diag and carried,
        cuda_scaled=metric.kind == "diag" and not target.cuda_affine,
        cuda_transform=target.cuda_transform,
        cuda_unsupported=target.cuda_unsupported,
        logp_normalized=logp_normalized,
        sep_form=sep_form,
    )
