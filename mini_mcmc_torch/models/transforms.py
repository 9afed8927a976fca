"""Constrained-parameter transforms: sample unconstrained, report natural.

Counterpart of ``mini_mcmc_tpu/models/transforms.py``. A per-coordinate
bijection ``x = g(y)`` with the change-of-variables term ``log |det dg/dy|``
added to the log density lets the chains explore ``y`` in R^D while the
user writes the density in ``x``:

    transform = CoordinateTransform({1: positive()}, dim=10)
    nuts = NUTS(target_x, x0, transform=transform)   # x0, samples natural

- Bijectors are elementwise; :class:`CoordinateTransform` groups the
  coordinates by bijector and applies each group with one masked
  ``torch.where`` over the whole ``[..., D]`` tensor. The built-in
  factories are ``lru_cache``d, so ``{i: positive() for i in range(d)}``
  is one group (one masked pass), not ``d``.
- The built-in bijectors soft-saturate their pre-image
  (:func:`_soft_saturate`) so that ``exp``/``sigmoid`` never leave the
  float range, and compute ``log sech^2`` in its stable form: log density
  and gradient stay finite for every ``y``.
- Derivatives: a built-in bijector carries its closed forms
  (``dforward``, ``dlog_det``), the formulas the CUDA kernels evaluate
  (``csrc/targets.cuh:bijector``); a custom :class:`Bijector` gets them by
  autograd of its ``forward`` and ``log_det`` (:func:`_elem_grad`), as the
  JAX package gets every one by AD.
- :meth:`CoordinateTransform.wrap` carries the batch, analytic-gradient,
  normalized and ``sep_form`` forms, and the CUDA description of the
  transform (``Target.cuda_transform``): the hand-written kernels of the
  HMC, NUTS and separable tiers run the wrapped target through their
  ``Transformed`` functors. A transform holding a custom bijector, or one
  wrapped around a target that is already whitened or transformed, has no
  CUDA form (``Target.cuda_unsupported``): it runs on the plain tiers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..ops.kernels._build import kernel_dims
from .base import Target, cuda_base_of

#: the CUDA kernels' bijector codes (``csrc/targets.cuh:BijCode``)
BIJ_IDENTITY, BIJ_POSITIVE, BIJ_LOWER, BIJ_UPPER, BIJ_INTERVAL = range(5)


@dataclasses.dataclass(frozen=True, eq=False)
class Bijector:
    """An elementwise bijection ``x = forward(y)`` from R onto an interval.

    Attributes:
        forward: ``y -> x``, total on R (applied under a mask to the whole
            state tensor: a partial function would give NaN in masked-out
            entries).
        inverse: ``x -> y`` on the bijector's range (used on initial
            positions; never differentiated).
        log_det: ``y -> log |d forward / dy|`` elementwise.
        name: display name for reprs and errors.
        dforward, dlog_det: the derivatives of ``forward`` and ``log_det``
            in closed form, or ``None``: autograd then derives them.
        cuda: ``(code, offset, width)``, the CUDA kernels' form of a
            built-in bijector (``x = offset + width * exp(y')`` for codes
            1-3, ``offset + width * sigmoid(y')`` for code 4), or ``None``
            for a custom one, which the kernels cannot run.
    """

    forward: Callable
    inverse: Callable
    log_det: Callable
    name: str = "bijector"
    dforward: Optional[Callable] = None
    dlog_det: Optional[Callable] = None
    cuda: Optional[tuple] = None


@functools.lru_cache(maxsize=None)
def identity() -> Bijector:
    """x = y (the default for unlisted coordinates)."""
    return Bijector(lambda y: y, lambda x: x, torch.zeros_like, "identity",
                    torch.ones_like, torch.zeros_like,
                    (BIJ_IDENTITY, 0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class _SoftSat:
    """The maps of :func:`_soft_saturate`."""

    params: Callable  # dtype -> (a, s)
    pre: Callable
    pre_log_det: Callable
    pre_inverse: Callable
    dpre: Callable
    dpre_log_det: Callable


def _soft_saturate(lim_of_finfo) -> _SoftSat:
    """A C^2 pre-squash ``y -> y'`` that is exactly the identity on the
    core ``|y| <= L/2`` and saturates smoothly onto ``(-L, L)`` beyond
    (``sign(y) * (L/2 + L/2 * tanh((|y| - L/2) / (L/2)))``), with ``L``
    chosen per dtype from ``torch.finfo`` as the JAX package chooses it
    from ``jnp.finfo``, so the downstream ``exp``/``sigmoid`` never leaves
    the representable range (``transforms.py:79-130`` there).

    The squash is a smooth increasing bijection with its exact Jacobian
    accounted, so the density of x is the user's; log density and
    gradient stay finite for all y. The derivatives, with ``u = (|y| - a)
    / s``: ``pre' = 1`` in the core and ``sech^2(u) = (1 - tanh u)(1 +
    tanh u)`` beyond it; ``d(pre_log_det)/dy = -2 tanh(u) sign(y) / s``
    beyond it, 0 in the core. At ``|y| = a`` both take the core's value,
    as AD through ``jnp.where`` does.
    """

    def params(dtype):
        lim = float(lim_of_finfo(torch.finfo(dtype)))
        a = 0.5 * lim
        return a, lim - a  # core half-width, saturation scale

    def pre(y):
        a, s = params(y.dtype)
        ay = torch.abs(y)
        sat = torch.sign(y) * (a + s * torch.tanh((ay - a) / s))
        return torch.where(ay <= a, y, sat)

    def pre_log_det(y):
        a, s = params(y.dtype)
        u = (torch.abs(y) - a) / s
        # log sech^2(u) stably: 2 log 2 - 2u - 2 log1p(e^-2u). The naive
        # log1p(-tanh(u)^2) hits tanh == 1.0 for u > ~19 and returns -inf
        # with a NaN gradient
        log_sech2 = (2.0 * math.log(2.0) - 2.0 * u
                     - 2.0 * torch.log1p(torch.exp(-2.0 * u)))
        return torch.where(torch.abs(y) <= a, torch.zeros_like(y), log_sech2)

    def pre_inverse(z):
        a, s = params(z.dtype)
        az = torch.abs(z)
        arg = torch.clamp((az - a) / s, 0.0, 1.0 - 1e-7)
        sat = torch.sign(z) * (a + s * torch.atanh(arg))
        return torch.where(az <= a, z, sat)

    def dpre(y):
        a, s = params(y.dtype)
        ay = torch.abs(y)
        t = torch.tanh((ay - a) / s)
        return torch.where(ay <= a, torch.ones_like(y), (1.0 - t) * (1.0 + t))

    def dpre_log_det(y):
        a, s = params(y.dtype)
        ay = torch.abs(y)
        t = torch.tanh((ay - a) / s)
        return torch.where(ay <= a, torch.zeros_like(y),
                           -2.0 * t * torch.sign(y) / s)

    return _SoftSat(params, pre, pre_log_det, pre_inverse, dpre,
                    dpre_log_det)


#: exp() stays inside the float range over the squashed image
_EXP_LIM = _soft_saturate(lambda fi: 0.9 * math.log(float(fi.max)))
#: sigmoid() stays at least one ulp away from 0 and 1 over it
_SIG_LIM = _soft_saturate(lambda fi: -math.log(float(fi.eps)))


def _exp_family(offset: float, sign: float, name: str, code: int,
                forward: Callable, inverse: Callable) -> Bijector:
    """``x = offset + sign * exp(y')`` (positive, lower and upper bounds):
    ``log |dx/dy| = y' + log pre'``, ``dx/dy = sign exp(y') pre'``."""
    q = _EXP_LIM

    def dforward(y):
        return sign * torch.exp(q.pre(y)) * q.dpre(y)

    return Bijector(forward, inverse, lambda y: q.pre(y) + q.pre_log_det(y),
                    name,
                    dforward=dforward,
                    dlog_det=lambda y: q.dpre(y) + q.dpre_log_det(y),
                    cuda=(code, offset, sign))


@functools.lru_cache(maxsize=None)
def positive() -> Bijector:
    """x = exp(y'): R -> (0, inf), for positive scales (tau, sigma).

    ``y'`` is the soft-saturated pre-image: exactly ``y`` for ``|y| <=
    ~40`` (float32) / ``~319`` (float64), smoothly bounded beyond."""
    q = _EXP_LIM
    return _exp_family(0.0, 1.0, "positive", BIJ_POSITIVE,
                       lambda y: torch.exp(q.pre(y)),
                       lambda x: q.pre_inverse(torch.log(x)))


@functools.lru_cache(maxsize=None)
def lower_bounded(low: float) -> Bijector:
    """x = low + exp(y'): R -> (low, inf)."""
    low = float(low)
    q = _EXP_LIM
    return _exp_family(low, 1.0, f"lower_bounded({low:g})", BIJ_LOWER,
                       lambda y: low + torch.exp(q.pre(y)),
                       lambda x: q.pre_inverse(torch.log(x - low)))


@functools.lru_cache(maxsize=None)
def upper_bounded(high: float) -> Bijector:
    """x = high - exp(y'): R -> (-inf, high). Decreasing in y (the
    log-Jacobian is of the absolute derivative)."""
    high = float(high)
    q = _EXP_LIM
    return _exp_family(high, -1.0, f"upper_bounded({high:g})", BIJ_UPPER,
                       lambda y: high - torch.exp(q.pre(y)),
                       lambda x: q.pre_inverse(torch.log(high - x)))


def _interval(low: float, width: float, name: str) -> Bijector:
    """``x = low + width * sigmoid(y')``; :func:`interval`'s body, taking
    the width as the JAX package computes it (``high - low``)."""
    q = _SIG_LIM

    def fwd(y):
        return low + width * torch.sigmoid(q.pre(y))

    def inv(x):
        p = (x - low) / width
        return q.pre_inverse(torch.log(p) - torch.log1p(-p))

    def ld(y):
        # log(width * sigmoid(y') * (1 - sigmoid(y'))) + log dy'/dy
        yp = q.pre(y)
        return (math.log(width) - yp - 2.0 * torch.log1p(torch.exp(-yp))
                + q.pre_log_det(y))

    def dfwd(y):
        sig = torch.sigmoid(q.pre(y))
        return width * sig * (1.0 - sig) * q.dpre(y)

    def dld(y):
        sig = torch.sigmoid(q.pre(y))
        return (1.0 - 2.0 * sig) * q.dpre(y) + q.dpre_log_det(y)

    return Bijector(fwd, inv, ld, name, dforward=dfwd, dlog_det=dld,
                    cuda=(BIJ_INTERVAL, low, width))


@functools.lru_cache(maxsize=None)
def interval(low: float, high: float) -> Bijector:
    """x = low + (high - low) * sigmoid(y'): R -> (low, high), for
    bounded parameters (probabilities, correlations).

    ``y'`` is soft-saturated (exactly ``y`` for ``|y| <= ~8`` in float32 /
    ``~18`` in float64), so ``sigmoid`` stays at least one ulp inside
    (0, 1) and a density's ``log(p)``/``log1p(-p)`` stays finite."""
    low, high = float(low), float(high)
    if not high > low:
        raise ValueError(f"need high > low, got ({low}, {high})")
    return _interval(low, high - low, f"interval({low:g}, {high:g})")


def _elem_grad(f: Callable) -> Callable:
    """The elementwise derivative of an elementwise map by autograd with a
    ones cotangent (the Jacobian is diagonal)."""

    def df(y):
        y = y.detach().requires_grad_(True)
        with torch.enable_grad():
            out = f(y)
            (g,) = torch.autograd.grad(out, y, torch.ones_like(out))
        return g

    return df


def _dforward(bij: Bijector) -> Callable:
    return bij.dforward or _elem_grad(bij.forward)


def _dlog_det(bij: Bijector) -> Callable:
    return bij.dlog_det or _elem_grad(bij.log_det)


class CoordinateTransform:
    """Per-coordinate bijector stack over a ``[..., D]`` state.

    Args:
        bijectors: a sequence of ``D`` :class:`Bijector` (one per
            coordinate; :func:`identity` for unconstrained ones) or a
            ``{coordinate_index: Bijector}`` mapping with identity default
            (then ``dim`` is required).
        dim: state dimension (required with a mapping; checked against a
            sequence).
    """

    def __init__(self, bijectors, dim: Optional[int] = None):
        if isinstance(bijectors, Mapping):
            if dim is None:
                raise ValueError("dim is required when bijectors is a "
                                 "{index: Bijector} mapping")
            table = [None] * dim
            for idx, bij in bijectors.items():
                i = int(idx)
                if not -dim <= i < dim:
                    raise ValueError(
                        f"coordinate index {i} out of range for dim={dim}")
                table[i] = bij
        else:
            table = list(bijectors)
            if dim is not None and len(table) != dim:
                raise ValueError(f"got {len(table)} bijectors for dim={dim}")
        self.dim = len(table)
        self._table = [b if b is not None else identity() for b in table]
        # one masked whole-tensor pass per distinct bijector object: the
        # built-in factories are cached, so equal built-ins share a group;
        # custom instances group by identity
        groups: dict[int, tuple[Bijector, list[int]]] = {}
        for d, bij in enumerate(self._table):
            if bij.name == "identity":
                continue
            groups.setdefault(id(bij), (bij, []))[1].append(d)
        self._groups = []
        for bij, idxs in groups.values():
            mask = torch.zeros(self.dim, dtype=torch.bool)
            mask[idxs] = True
            self._groups.append((bij, mask))
        self._masks_on = {}  # device -> [(mask, covers every coordinate)]

    def __repr__(self):
        named = {d: b.name for d, b in enumerate(self._table)
                 if b.name != "identity"}
        return f"CoordinateTransform(dim={self.dim}, {named})"

    @property
    def is_identity(self) -> bool:
        return not self._groups

    @property
    def cuda_form(self) -> Optional[tuple]:
        """Each coordinate's ``(code, offset, width)``, the kernels' form
        of the transform, or ``None`` when a custom bijector has none."""
        if any(b.cuda is None for b in self._table):
            return None
        return tuple(b.cuda for b in self._table)

    def _groups_on(self, like: torch.Tensor):
        """``(bijector, mask, full)`` per group, the masks on ``like``'s
        device (copied there once); ``full``: the group covers every
        coordinate, and its pass needs no select."""
        dev = like.device
        if dev not in self._masks_on:
            self._masks_on[dev] = [(m.to(dev), bool(m.all()))
                                   for _, m in self._groups]
        return [(bij, m, full) for (bij, _), (m, full)
                in zip(self._groups, self._masks_on[dev])]

    def _select(self, fn_of, y, base):
        out = base
        for bij, mask, full in self._groups_on(y):
            val = fn_of(bij)(y)
            out = val if full else torch.where(mask, val, out)
        return out

    # -- tensor maps (trailing coordinate axis) ------------------------------
    def to_x(self, y: torch.Tensor) -> torch.Tensor:
        """Unconstrained ``[..., D]`` -> natural coordinates."""
        return self._select(lambda b: b.forward, y, y)

    def to_y(self, x: torch.Tensor) -> torch.Tensor:
        """Natural ``[..., D]`` -> unconstrained (for initial positions).
        Masked entries may evaluate ``inverse`` outside its range; the
        built-in inverses give NaN there, which the mask discards."""
        x = torch.as_tensor(x)
        return self._select(lambda b: b.inverse, x, x)

    def log_det(self, y: torch.Tensor) -> torch.Tensor:
        """``[..., D]`` -> ``[...]`` summed log-Jacobian."""
        acc = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        for bij, mask, _ in self._groups_on(y):
            acc = acc + torch.sum(
                torch.where(mask, bij.log_det(y), torch.zeros_like(y)),
                dim=-1)
        return acc

    def density_rounding(self, target: Target,
                         y: torch.Tensor) -> torch.Tensor:
        """A bound ``[N]`` (float64) on the float32 rounding of
        ``self.wrap(target)``'s density at the unconstrained ``y [N, D]``:
        eight float32 ulps of each coordinate's ``|offset| + |x|`` (``x =
        offset + width sigmoid(y')`` loses digits to the offset) through
        the natural density's gradient, plus eight ulps of the natural
        density's and the log-Jacobian's magnitudes. A kernel's
        transformed functor and its twin each round within it, so checks
        hold them to each other within twice it. Built-in bijectors only
        (their offsets are ``cuda_form``'s)."""
        y64 = y.double()
        x = self.to_x(y64).detach().requires_grad_(True)
        with torch.enable_grad():
            lp = target.batch_logp(x)
            (gx,) = torch.autograd.grad(lp.sum(), x)
        off = torch.tensor([abs(c[1]) for c in self.cuda_form],
                           dtype=torch.float64, device=y.device)
        return 8 * torch.finfo(torch.float32).eps * (
            (gx.abs() * (off + x.detach().abs())).sum(-1)
            + lp.detach().abs() + self.log_det(y64).abs())

    def _dx_dy(self, y: torch.Tensor) -> torch.Tensor:
        """Elementwise ``d forward / dy`` over ``[..., D]``."""
        return self._select(_dforward, y, torch.ones_like(y))

    def _dlogdet_dy(self, y: torch.Tensor) -> torch.Tensor:
        return self._select(_dlog_det, y, torch.zeros_like(y))

    # -- target wrapping -----------------------------------------------------
    def wrap(self, target: Target) -> Target:
        """The unconstrained-space target ``logp_y(y) = logp_x(to_x(y)) +
        log_det(y)``.

        Carried over: the batch form, an analytic gradient (the chain rule
        through the diagonal Jacobian, ``g_x * dx/dy + dlog_det/dy``), the
        normalized form (it is the density of y), and the separable tier's
        ``sep_form``: per-coordinate bijectors keep separability, and each
        group's membership mask rides one more coordinate table after the
        inner target's (``transforms.py:408-438`` in the JAX package).

        The CUDA form: ``cuda_functor`` or ``cuda_source`` stays the inner
        target's (a Python density's, ``cuda_base``, the kernels trace), and
        ``cuda_transform`` describes the transform, each coordinate's
        ``(code, offset, width)``; where Kernels 1-4 run the target
        (``_build.kernel_dims``) ``cuda_params`` starts with
        :func:`transform_params` of it, ahead of the inner target's
        coefficients; above, the separable kernel reads its own table. A transform holding a custom
        bijector, or around a target already whitened or transformed, sets
        ``cuda_unsupported`` instead and runs on the plain tiers only.
        """
        if self.is_identity:
            return target
        tf = self

        def logp(y, _f=target.logp):
            return _f(tf.to_x(y)) + tf.log_det(y)

        logp_batch = grad = logp_normalized = None
        if target.logp_batch is not None:
            def logp_batch(ys, _f=target.logp_batch):
                return _f(tf.to_x(ys)) + tf.log_det(ys)

        if target.grad is not None:
            def grad(y, _f=target.grad):
                return _f(tf.to_x(y)) * tf._dx_dy(y) + tf._dlogdet_dy(y)

        if target.logp_normalized is not None:
            def logp_normalized(y, _f=target.logp_normalized):
                return _f(tf.to_x(y)) + tf.log_det(y)

        inner_tile, inner_tabs = target.sep_forms()
        n_inner = len(inner_tabs)
        group_bijs = [bij for bij, _ in self._groups]

        def sep_tile_logp(y, *tabs, _f=inner_tile, _n=n_inner,
                          _bijs=group_bijs):
            x = y
            acc = y.new_zeros(y.shape[:-1])
            zero = torch.zeros_like(y)
            for bij, m in zip(_bijs, tabs[_n:]):
                sel = m > 0
                x = torch.where(sel, bij.forward(y), x)
                acc = acc + torch.sum(torch.where(sel, bij.log_det(y), zero),
                                      dim=-1)
            return _f(x, *tabs[:_n]) + acc

        sep_form = (sep_tile_logp, tuple(inner_tabs) + tuple(
            mask.to(torch.float32) for _, mask in self._groups))

        cuda_transform, unsupported = None, target.cuda_unsupported
        if unsupported is None:
            custom = [b.name for b in self._table if b.cuda is None]
            if custom:
                unsupported = (f"the transform holds a custom Bijector "
                               f"({custom[0]!r}), which has no CUDA form")
            elif target.cuda_affine:
                unsupported = (
                    "a transform around a whitened target: the kernels run "
                    "a metric around a transform (Whitened<Transformed<T>>),"
                    " not the reverse")
            elif target.cuda_transform is not None:
                unsupported = "a transform around a transformed target"
            else:
                cuda_transform = self.cuda_form
        cuda_params = tuple(target.cuda_params)
        if cuda_transform is not None and self.dim <= max(
                kernel_dims(target)):
            cuda_params = transform_params(cuda_transform) + cuda_params
        return Target(
            logp=logp,
            logp_batch=logp_batch,
            grad=grad,
            cuda_functor=target.cuda_functor,
            cuda_source=target.cuda_source,
            cuda_params=cuda_params,
            cuda_coord_source=target.cuda_coord_source,
            cuda_base=cuda_base_of(target),
            cuda_affine=target.cuda_affine,
            cuda_diag=target.cuda_diag,
            cuda_transform=cuda_transform,
            cuda_unsupported=unsupported,
            logp_normalized=logp_normalized,
            sep_form=sep_form,
        )


def soft_saturation_constants(dtype=torch.float32) -> tuple:
    """The constants of both squashes at ``dtype`` as the kernels take
    them from the host: ``(a, s, 1 / s)`` of ``exp``'s, then of
    ``sigmoid``'s (``a = s`` ~= 39.93 and ~= 7.971 at float32; ~= 319.4
    and ~= 18.02 at float64, Kernel 1's float64 instances)."""
    out = ()
    for q in (_EXP_LIM, _SIG_LIM):
        a, s = q.params(dtype)
        out += (a, s, 1.0 / s)
    return out


def transform_params(cuda_transform: Sequence[tuple]) -> tuple:
    """The kernels' bijector table (``csrc/targets.cuh:Transformed``):
    :func:`soft_saturation_constants`, then each coordinate's ``(code,
    offset, width)``."""
    return soft_saturation_constants() + tuple(
        float(v) for entry in cuda_transform for v in entry)


def transformed_target(
    target: Target,
    bijectors: Sequence[Bijector] | Mapping[int, Bijector],
    dim: Optional[int] = None,
):
    """Build the :class:`CoordinateTransform` and wrap ``target``; returns
    ``(wrapped_target, transform)``."""
    tf = CoordinateTransform(bijectors, dim=dim)
    return tf.wrap(target), tf
