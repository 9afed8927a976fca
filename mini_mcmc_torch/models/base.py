"""The ``Target``, ``Proposal`` and ``Conditional`` abstractions, in PyTorch.

Counterpart of ``mini_mcmc_tpu/models/base.py:30-95,439-494``. Densities
are plain functions on tensors. ``logp`` and ``grad`` act on the trailing
axis of a ``[..., D]`` tensor, so a ``[C, D]`` batch goes through them as
it is (the
JAX package maps a per-state function with ``vmap``; broadcasting is the
PyTorch idiom for the same thing). Without an analytic ``grad`` the
gradient comes from autograd.

The JAX package's ``[D, C]`` chains-on-lanes forms exist for the TPU's
compiler; their counterpart here is C++, one thread a chain. The
hand-written CUDA kernels run a target's density as a built-in device
functor named in ``cuda_functor`` (``csrc/targets.cuh``) or, in Kernels
1-4 (HMC, MALA, NUTS), as the user's own C++, ``cuda_source``, or C++
generated from the batch form (``Target.dc_forms``,
``ops/kernels/user_density.py``), checked against the batch form at
sampler construction (:func:`validate_dc_forms`); MH and tempering (5 and
8) read its value alone, through a value-only library. The separable
kernel (7) runs a coordinate functor: built in, ``cuda_coord_source``, or
one generated from the ``sep_form`` (:func:`validate_coord_dc`). A
proposal or a Gibbs conditional names its built-in form in
``cuda_functor`` (``csrc/proposals.cuh``, ``csrc/conditionals.cuh``) or
carries its own C++, ``cuda_source``, with a PyTorch twin that draws from
the same Philox words (``propose_words``, ``sample_words``; checked by
:func:`validate_proposal_dc` and :func:`validate_conditional_dc`): the
counterparts of the JAX package's ``propose_dc`` and ``sample_dc``.
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
        cuda_source: the C++ of this target's density for Kernels 1-4, or
            ``None``: one functor ``Density`` with a constructor from
            ``const float* params`` (``cuda_params``), ``template <class
            S, int D> S logp(const S (&x)[D]) const``, templated on the
            scalar so that dual numbers run it, and optionally ``template
            <int D> void grad(const float (&x)[D], float (&g)[D])
            const``; without it the kernels take the gradient from dual
            numbers (``csrc/user_density.cuh`` states the contract and the
            math it may call). A target with neither a functor nor a
            source reaches Kernels 1-4 through C++ generated from its
            batch form (:meth:`dc_forms`). Naming both a functor and a
            source raises.
        cuda_params: the functor's coefficients, a tuple of floats handed
            to the kernels as a ``const float*`` (e.g. the Gaussian's mean,
            inverse covariance and normalizing constant); empty when the
            functor has none.
        cuda_base: the target whose batch form the kernels trace when this
            one wraps it (a metric or a transform around a target with
            neither a functor nor a source), else ``None``.
        cuda_affine: the kernels run the target's functor inside the
            affine wrapper of a whitened target
            (``csrc/targets.cuh:Whitened``, set by
            ``models.precondition.precondition_target``): then, where
            Kernels 1-4 run it (``_build.kernel_dims``), ``cuda_params``
            starts with the lower triangle of ``L``, row by row,
            ``D (D + 1) / 2`` floats, before the functor's own; under
            ``cuda_diag`` with the D scales of a diagonal metric instead
            (``csrc/targets.cuh:WhitenedDiag``, D above
            ``_build.DIAG_TRIANGLE_MAX_DIM``).
        cuda_diag: see ``cuda_affine``.
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
            on the same tables instead, or ``cuda_coord_source``, or the
            functor generated from ``tile_logp`` on one coordinate.
        cuda_coord_source: the C++ of this target's coordinate term for the
            separable kernel, or ``None``: one functor ``Coord`` with
            ``static constexpr int kTables`` (its ``sep_form`` tables,
            0-2), a constructor from ``const float* params``
            (``cuda_params``), ``template <class S> S logp(S x, const
            mm::CoordTables<kTables>& t) const`` (one coordinate's term,
            ``t`` its table entries; ``S`` float or ``mm::Dual<1>``) and
            optionally ``float grad(float x, const
            mm::CoordTables<kTables>& t) const``
            (``csrc/user_density.cuh:UserCoord``). Without it, and
            without a coordinate ``cuda_functor``, the kernel runs the
            functor generated from ``sep_forms()``'s ``tile_logp``.
    """

    logp: Callable
    logp_batch: Optional[Callable] = None
    grad: Optional[Callable] = None
    cuda_functor: Optional[str] = None
    cuda_source: Optional[str] = None
    cuda_params: tuple = ()
    cuda_coord_source: Optional[str] = None
    cuda_base: Optional["Target"] = None
    cuda_affine: bool = False
    cuda_diag: bool = False
    cuda_scaled: bool = False
    cuda_transform: Optional[tuple] = None
    cuda_unsupported: Optional[str] = None
    logp_normalized: Optional[Callable] = None
    sep_form: Optional[tuple] = None

    def __post_init__(self):
        if self.cuda_functor is not None and self.cuda_source is not None:
            raise ValueError(
                "a Target names a built-in cuda_functor or its own "
                f"cuda_source, not both (got {self.cuda_functor!r} and a "
                "source)")

    def dc_forms(self, dim: int, device="cpu", dtype=torch.float32):
        """What Kernels 1-4 compile for this target at ``dim``
        (``mini_mcmc_tpu/models/base.py:97-125``): a :class:`DcForms` of
        the source (``cuda_source``, or the C++ :func:`derive_logp_dc`
        generates from the batch form, traced on ``device``), every float
        the instance reads, and whether its gradient is the source's own
        (``"hand"``) or the dual numbers' (``"derived"``). ``dtype``: the
        states' (float64: Kernel 1's float64 instance; int32: the MH
        kernel's value-only int32 density). Raises for a built-in
        ``cuda_functor``, and for a batch form the generator cannot
        translate, naming the operation."""
        from ..ops.kernels.user_density import dc_forms

        return dc_forms(self, dim, device, dtype)

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

    def logp_and_grad(self, position: torch.Tensor):
        """Value and gradient for a single ``[D]`` state -> (scalar,
        ``[D]``), on the state's own device."""
        if self.grad is not None:
            return self.logp(position), self.grad(position)
        x = position.detach().requires_grad_(True)
        with torch.enable_grad():
            val = self.logp(x)
            (grad,) = torch.autograd.grad(val, x)
        return val.detach(), grad

    def sep_forms(self):
        """``(tile_logp, tables)`` for the separable HMC tier, the tables
        normalized to ``[1, D]`` tensors (``base.py:127-149`` in the JAX
        package). Without a ``sep_form`` it is the batch form and no
        table."""
        if self.sep_form is not None:
            fn, tables = self.sep_form
            return fn, tuple(_norm_sep_table(t) for t in tables)
        return (lambda x, _f=self.batch_logp: _f(x)), ()


def cuda_base_of(target: Target) -> Optional[Target]:
    """The ``cuda_base`` of a metric's or a transform's wrapper around
    ``target``: the target whose batch form (or tile form, for the
    separable kernel) the kernels trace or whose coordinate source they
    compile, ``None`` when ``target`` names a functor, or a density source
    without a coordinate source."""
    if target.cuda_functor is not None or (
            target.cuda_source is not None
            and target.cuda_coord_source is None):
        return None
    return target.cuda_base or target


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


#: ``validate_dc_forms``'s tolerance (rtol, atol) for a float64 probe, where
#: the JAX package's float32 rule would pass a float64 instance that
#: computes at float precision (``f``-suffixed literals, ``expf``)
F64_DC_TOL = (1e-10, 1e-10)


def validate_dc_forms(target: Target, positions, *,
                      rtol: float | None = None, atol: float | None = None,
                      max_rows: int = 256, need_grad: bool = True,
                      proposal=None) -> None:
    """Raise ``ValueError`` unless the compiled density of ``target`` (the
    instance Kernels 1-4 run: ``cuda_source`` or the generated C++, inside
    the target's metric and transform wrappers) agrees with its batch form
    on up to ``max_rows`` of ``positions`` (kernel coordinates), the logp
    and, with ``need_grad``, the gradient against autograd's
    (``mini_mcmc_tpu/models/base.py:214-345``).

    The rule is the JAX package's: ``|got - want| <= atol max(|want|, 1)
    + rtol |want|``, both ``-inf`` agreeing, at its tolerance (rtol 3e-4,
    atol 1e-4) by default, and at :data:`F64_DC_TOL` for a float64 probe;
    the gradient is compared where the batch form's is finite. The probe runs where the positions lie: on
    the card the per-density library's probe entry (built if need be), on
    the CPU the host build of the same source (``g++``, for the tests);
    without ``need_grad`` the value-only library's (Kernels 5 and 8),
    which compiles no dual numbers: that of (``target``, ``proposal``),
    the library MH launches beside a user ``proposal`` (``None``: the
    isotropic walk's, tempering's). A target with a built-in
    ``cuda_functor`` validates trivially. The samplers call it at
    construction for ``use_pallas`` on CUDA (``validate_dc``; MH and
    tempering with ``need_grad=False``, as the JAX samplers,
    ``mini_mcmc_tpu/samplers.py:295-300,805-809``); it never replaces the
    separability check of ``use_pallas="separable"``.

    Float64 positions probe Kernel 1's float64 instance against the batch
    form at float64. Integer positions probe the MH kernel's int32
    instance (value only) against the batch form on int32 rows, and on
    four rows beside them that may lie off the support (every coordinate
    -1, the rows' least less 1, their greatest plus 1, and 2**20), where
    both must give the same value or both ``-inf``.
    """
    if target.cuda_functor is not None:
        return
    from ..ops.kernels.user_density import _state_dtype, probe

    x = torch.as_tensor(positions).detach()[:max_rows]
    if x.dim() != 2:
        raise ValueError("positions must be [n_chains, D]; got shape "
                         f"{tuple(x.shape)}")
    dtype = _state_dtype(x, need_grad)
    f64 = dtype == torch.float64
    rtol = (F64_DC_TOL[0] if f64 else 3e-4) if rtol is None else rtol
    atol = (F64_DC_TOL[1] if f64 else 1e-4) if atol is None else atol
    x = x.to(dtype)
    if dtype == torch.int32:
        x = torch.cat([x, _support_edges(x)])
    got_lp, got_g = probe(target, x, need_grad, proposal)
    forms = target.dc_forms(x.shape[1], x.device, dtype)
    if need_grad:
        want_lp, want_g = target.batch_logp_and_grad(x)
    else:
        want_lp, want_g = target.batch_logp(x), None
    checks = [("logp", want_lp, got_lp)]
    if need_grad:
        finite = torch.isfinite(want_g)
        checks.append((f"grad ({forms.grad})", torch.where(
            finite, want_g, 0.0), torch.where(finite, got_g, 0.0)))
    for what, want, got in checks:
        want, got = want.double(), got.double()
        close = _close(got, want, rtol, atol)
        if not bool(close.all()):
            err = (got - want).abs().nan_to_num(nan=float("inf"))
            worst = int(err.reshape(-1).argmax())
            kind = "generated" if forms.traced else "cuda_source"
            raise ValueError(
                f"the compiled {what} of the target's {kind} disagrees with "
                f"its batch form on the initial positions: max abs err "
                f"{float(err.max()):.3g} (flat index {worst}: "
                f"{float(got.reshape(-1)[worst]):.6g} vs "
                f"{float(want.reshape(-1)[worst]):.6g}). The kernels would "
                "sample the WRONG posterior. "
                + ("At float64 it is held to rtol and atol "
                   f"{rtol:g}: an f-suffixed literal (0.1f) or a float "
                   "function (expf, logf) keeps the double instance at "
                   "float precision; write 0.1 and exp, log. " if f64
                   else "")
                + "Fix the source (or pass validate_dc=False to skip this "
                "check).")


def _support_edges(x: torch.Tensor) -> torch.Tensor:
    """Four int32 rows like ``x``'s that may lie off a discrete target's
    support: every coordinate -1, ``x``'s least less 1, its greatest plus
    1, and 2**20."""
    d = x.shape[1]
    vals = (-1, int(x.min()) - 1, int(x.max()) + 1, 1 << 20)
    return torch.tensor(vals, dtype=torch.int32,
                        device=x.device)[:, None].expand(4, d)


def _close(got, want, rtol: float, atol: float) -> torch.Tensor:
    """``validate_dc_forms``'s rule, elementwise: both finite and within
    ``atol max(|want|, 1) + rtol |want|``, or both -inf (NaN in neither);
    a finite value against -inf is far, as ``np.isclose`` holds it (the
    tolerance scaled by an infinite |want| would pass anything)."""
    got, want = got.double(), want.double()
    close = ((got - want).abs()
             <= atol * want.abs().clamp(min=1.0) + rtol * want.abs())
    close &= torch.isfinite(got) & torch.isfinite(want)
    return close | (torch.isneginf(want) & torch.isneginf(got))


def _refuse(what: str, got, want, why: str) -> None:
    err = (got.double() - want.double()).abs().nan_to_num(nan=float("inf"))
    worst = int(err.reshape(-1).argmax())
    raise ValueError(
        f"the compiled {what} disagrees with its twin: max abs err "
        f"{float(err.max()):.3g} (flat index {worst}: "
        f"{float(got.reshape(-1)[worst]):.6g} vs "
        f"{float(want.reshape(-1)[worst]):.6g}). {why} Fix the source (or "
        "pass validate_dc=False to skip this check).")


#: the fixed Philox key of the proposal and conditional probes
_PROBE_SEED = 0x5EED_0D0C_0000_0017


def validate_proposal_dc(proposal: "Proposal", target: Target, positions,
                         *, rtol: float = 1e-5, atol: float = 1e-5,
                         max_rows: int = 256) -> None:
    """Raise ``ValueError`` unless a user proposal's compiled form
    (``cuda_source``) and its twin (``propose_words``) propose the same
    states from up to ``max_rows`` of ``positions`` on the same fixed
    Philox words, at float32 tolerance, and read the same number of words
    (``cuda_words``). The counterpart of the JAX package's single
    ``propose_dc``, which serves both its kernel and its interpret mode:
    here the kernel runs the source and the CPU twin the Python form, so
    the probe keeps the CPU tests truthful about the card. On the card
    the probe entry of Kernel 5's library of (``target``, ``proposal``),
    on the CPU the host build. Integer positions probe the int32 form,
    with :func:`validate_dc_forms`' four rows beside them. A built-in
    proposal validates trivially."""
    if proposal.cuda_functor is not None:
        return
    from ..ops.kernels import rng
    from ..ops.kernels.user_density import propose_probe

    x = torch.as_tensor(positions).detach()[:max_rows]
    if x.dtype in (torch.int32, torch.int64):
        x = x.to(torch.int32)
        x = torch.cat([x, _support_edges(x)])
    else:
        x = x.to(torch.float32)
    r, d = x.shape
    words = rng.stream_words(r, proposal.cuda_words(d), 0, _PROBE_SEED,
                             x.device)
    got = propose_probe(proposal, x, words, target)
    want = proposal.propose_words(proposal.cuda_params, x, words)
    if not bool(_close(got, want, rtol, atol).all()):
        _refuse("proposal (Proposal.cuda_source)", got, want,
                "The MH kernel would walk another chain than its twin.")


def validate_conditional_dc(conditional: "Conditional", positions, *,
                            rtol: float = 1e-5, atol: float = 1e-5,
                            max_rows: int = 256) -> None:
    """Raise ``ValueError`` unless a user conditional's compiled form
    (``cuda_source``) and its twin (``sample_words``) give the same sweep
    (coordinates ``0..D-1`` in order, each given the updated state) from
    up to ``max_rows`` of ``positions`` on the same fixed Philox words,
    at float32 tolerance, and read the same number of words
    (``cuda_words``); :func:`validate_proposal_dc`'s counterpart for the
    Gibbs kernel. A built-in conditional validates trivially."""
    if conditional.cuda_functor is not None:
        return
    from ..ops.kernels import rng
    from ..ops.kernels.user_density import sample_probe

    x = torch.as_tensor(positions).detach()[:max_rows].to(torch.float32)
    r, d = x.shape
    words = rng.stream_words(r, conditional.cuda_words(d), 0, _PROBE_SEED,
                             x.device)
    got = sample_probe(conditional, x, words)
    want = x.clone()
    for i in range(d):
        want[:, i] = conditional.sample_words(conditional.cuda_params, i,
                                              want, words)
    if not bool(_close(got, want, rtol, atol).all()):
        _refuse("sweep (Conditional.cuda_source)", got, want,
                "The Gibbs kernel would draw another chain than its twin.")


def validate_coord_dc(target: Target, positions, *, rtol: float = 3e-4,
                      atol: float = 1e-4, max_rows: int = 64) -> None:
    """Raise ``ValueError`` unless the separable kernel's instance for
    ``target`` (its coordinate functor, ``cuda_coord_source`` or the one
    generated from the tile form, inside the target's metric and
    transform wrappers: ``coord_targets.cuh:Scaled``,
    ``TransformedCoord``) gives each coordinate's term and derivative of
    the target's tile form, ``tile_logp`` on single coordinates and
    autograd, at up to ``max_rows`` of ``positions`` (the kernel's
    coordinates), at :func:`validate_dc_forms`'s tolerance (the derivative
    where the form's is finite). The counterpart of the JAX package's
    ``jax.vjp`` of ``tile_logp`` inside each tile
    (``ops/pallas/hmc_bigd.py:134-167``), which needs no check. A built-in
    coordinate functor validates trivially; :func:`validate_separable`
    still runs beside it."""
    if target.cuda_functor is not None:
        return
    from ..ops.kernels.user_density import coord_probe

    x = torch.as_tensor(positions).detach()[:max_rows].to(torch.float32)
    r, d = x.shape
    tile_logp, tables = target.sep_forms()
    tabs = [t.detach().to(x.device, torch.float32).reshape(1, d)
            for t in tables]
    got_lp, got_g = coord_probe(target, x)
    xs = x.T.reshape(d, r, 1).detach().requires_grad_(True)
    with torch.enable_grad():
        vals = torch.func.vmap(lambda xc, *tc: tile_logp(xc, *tc))(
            xs, *(t.T.reshape(d, 1, 1) for t in tabs))
        (g,) = torch.autograd.grad(vals.sum(), xs)
    want_lp, want_g = vals.detach().T, g.reshape(d, r).T
    finite = torch.isfinite(want_g)
    for what, got, want in (
            ("coordinate term", got_lp, want_lp),
            ("coordinate derivative", torch.where(finite, got_g, 0.0),
             torch.where(finite, want_g, 0.0))):
        if not bool(_close(got, want, rtol, atol).all()):
            _refuse(f"{what} (Target.cuda_coord_source or the generated "
                    "Coord)", got, want,
                    "The separable kernel would sample the WRONG posterior.")


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
        cuda_source: the C++ of a user proposal for the MH kernel, or
            ``None``: one functor ``Proposal`` with a constructor from
            ``const float*`` (``cuda_params``), ``template <int D>
            __host__ __device__ static constexpr int words()`` (the words
            of the step's Philox stream it reads; the accept takes the
            next) and ``template <int D> void propose(const float (&x)[D],
            const uint32_t* w, float (&y)[D]) const``
            (``csrc/proposals.cuh`` states the contract). Naming both a
            functor and a source raises.
        propose_words: the PyTorch twin of the fused proposal, ``(params,
            current [C, D], words [C, W]) -> proposed [C, D]`` on int64
            Philox words: the kernel's plain twin runs it, so it must draw
            as the source does (:func:`validate_proposal_dc`). Together
            with ``cuda_source`` the counterpart of the JAX package's
            ``propose_dc``.
        cuda_words: ``D -> W``, the words ``propose_words`` and the
            source's ``words<D>()`` read at D.
        takes_state_split: whether MH may run this proposal on a state
            whose D is split over a ``"state"`` axis: ``sample``'s draw at
            a coordinate reads no other coordinate of the row and ``logp``
            is a sum over D that runs on DTensor views (a random walk; the
            built-in walks set it). MH refuses a split D for any other.
    """

    sample: Callable
    logp: Callable
    symmetric: bool = False
    scaled: Optional[Callable] = None
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()
    cuda_source: Optional[str] = None
    propose_words: Optional[Callable] = None
    cuda_words: Optional[Callable] = None
    takes_state_split: bool = False

    def __post_init__(self):
        _one_form(self)


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
        cuda_source: the C++ of a user conditional for the Gibbs kernel,
            or ``None``: one functor ``Conditional`` with a constructor
            from ``const float*`` (``cuda_params``), ``template <int D>
            __host__ __device__ static constexpr int words()`` (the sweep's
            words) and ``template <int D> float sample(int i, const float
            (&s)[D], const uint32_t* w) const`` (``csrc/conditionals.cuh``
            states the contract). Naming both raises.
        sample_words: its PyTorch twin, ``(params, i, states [C, D], words
            [C, W]) -> coordinate i [C]`` (:func:`validate_conditional_dc`);
            with ``cuda_source`` the counterpart of ``sample_dc``.
        cuda_words: ``D -> W``, the words a sweep reads at D.
    """

    sample: Callable
    cuda_functor: Optional[str] = None
    cuda_params: tuple = ()
    cuda_source: Optional[str] = None
    sample_words: Optional[Callable] = None
    cuda_words: Optional[Callable] = None

    def __post_init__(self):
        _one_form(self)


def _one_form(form) -> None:
    """A proposal or conditional names a built-in form or brings its own
    source, not both."""
    if form.cuda_functor is not None and form.cuda_source is not None:
        raise ValueError(
            f"a {type(form).__name__} names a built-in cuda_functor or its "
            f"own cuda_source, not both (got {form.cuda_functor!r} and a "
            "source)")
