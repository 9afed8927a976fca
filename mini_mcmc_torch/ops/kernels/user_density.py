"""User forms inside the kernels: a Target's, Proposal's or Conditional's
C++ compiled into a library of its own.

Counterpart of the JAX package's ``Target.dc_forms``, ``derive_logp_dc``
and ``derive_grad_dc`` (``mini_mcmc_tpu/models/base.py:97-125,168-211``),
through which a plain ``Target(logp=...)`` reaches every fused Pallas tier.
CUDA cannot run a Python density, so a target that names no built-in
functor reaches Kernels 1-4 as C++ (``csrc/user_density.cuh`` states the
contract):

- ``Target.cuda_source``, written by hand, with or without its own
  gradient; :func:`derive_grad_dc` drops a source's gradient, so that the
  kernels derive it by dual numbers;
- otherwise the source :func:`derive_logp_dc` generates from the target's
  PyTorch batch form, traced with ``make_fx`` into aten operations and
  written out one node at a time.

:func:`lib_for` compiles a source at one D under one set of wrapper bits
(``_build.instance_flags``: a metric, a transform) into a library of its
own, four ``nvcc`` processes at once, named by a hash of the source, D,
the bits, the flags and the headers, in ``build/mini_mcmc_torch/``; it
exports the C entries of the built-in library (``_build.lib``) for its one
instance, and ``mm_user_probe``, which :func:`probe` and
``models.base.validate_dc_forms`` hold against the batch form. A compile
error raises with nvcc's output. Nothing here traces or compiles on the
CPU, where the fused tiers run their plain twins on ``batch_logp``; only
the tests build a source for the host with ``g++`` (:func:`host_probe_lib`,
``csrc/host_shim.h``).

Kernels 5-8 (:class:`Spec` kinds): MH and tempering read a density's value
alone, so a user density (or a built-in functor beside a user proposal,
``Proposal.cuda_source``) compiles into a value-only library
(:func:`value_spec`: ``mm_mh_multistep``, ``mm_pt_multistep`` at D =
1-16, ``mm_user_probe_value`` and ``mm_user_propose_probe``), with no dual
numbers; a user conditional (``Conditional.cuda_source``) into a Gibbs
library (:func:`gibbs_spec`); a coordinate functor (``Target.
cuda_coord_source``, or :func:`derive_coord_dc` from the tile form) into
Kernel 7's library, one per functor and wrapper bits, any D
(:func:`sep_spec`). The probes hold each compiled form to its PyTorch twin
(``models.base.validate_*_dc``); a library's name hashes its kind with the
rest.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.fx.node import map_arg
from torch.utils._pytree import tree_leaves

from . import _build

#: the D of the user instances of Kernels 1-4
MAX_DIM = _build.WRAPPED_MAX_DIM
#: where a per-density library's generated sources and objects go
GEN_DIR = _build.BUILD_DIR / "user"
#: the mark :func:`derive_grad_dc` leaves in a source
DERIVED_MARK = "// mm: gradient derived by dual numbers (derive_grad_dc)"
_HAND_GRAD = re.compile(r"\bvoid\s+grad\s*\(")

_P = ctypes.c_void_p
_I = ctypes.c_int


class DcForms(NamedTuple):
    """What the kernels compile for a target at one D (``Target.dc_forms``).

    ``source``: the functor's C++; ``params``: every float the instance
    reads (a metric's or a transform's table, then the functor's own, then
    a traced density's constants); ``grad``: ``"hand"`` when the source
    defines its gradient, ``"derived"`` when the kernels take it from dual
    numbers; ``traced``: whether the source was generated from the batch
    form.
    """

    source: str
    params: tuple
    grad: str
    traced: bool


def grad_kind(source: str) -> str:
    """``"hand"`` if ``source`` defines ``grad``, else ``"derived"``."""
    if DERIVED_MARK in source or not _HAND_GRAD.search(source):
        return "derived"
    return "hand"


def derive_grad_dc(source: str) -> str:
    """``source`` with its gradient dropped: a ``Density`` that forwards
    ``logp`` to the given one and defines no ``grad``, so that the kernels
    derive the gradient by dual numbers (``mm::User``). The counterpart of
    the JAX package's ``derive_grad_dc`` (``base.py:188-211``)."""
    return f"""{DERIVED_MARK}
namespace hand {{
{source}
}}  // namespace hand

struct Density {{
  hand::Density f;
  __device__ __forceinline__ explicit Density(const float* p) : f(p) {{}}
  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {{
    return f.template logp<S, D>(x);
  }}
}};
"""


def dc_forms(target, dim: int, device="cpu",
             dtype=torch.float32) -> DcForms:
    """The C++ the kernels compile for ``target`` at ``dim`` for states
    of ``dtype``: its ``cuda_source``, or the one :func:`derive_logp_dc`
    traces from the batch form of the target it wraps (``cuda_base``) or
    of itself, the trace on ``device`` at ``dtype``. At float64 the params
    are :func:`_build.kernel_params`' (a transform's float64 squashes);
    an int32 source is value-only (``grad`` ``"none"``)."""
    if target.cuda_functor is not None:
        raise ValueError(
            f"Target.cuda_functor {target.cuda_functor!r} is built in "
            "(csrc/targets.cuh): it has no source to compile")
    params = _build.kernel_params(target, dim, dtype)
    if target.cuda_source is not None:
        return DcForms(target.cuda_source, params,
                       "none" if dtype == torch.int32
                       else grad_kind(target.cuda_source), False)
    base = target.cuda_base or target
    source, traced = _traced(base, dim, torch.device(device).type, dtype)
    return DcForms(source, params + traced[len(base.cuda_params):],
                   "none" if dtype == torch.int32 else "derived", True)


@functools.lru_cache(maxsize=64)
def _traced(base, dim: int, device_type: str, dtype=torch.float32):
    return derive_logp_dc(base, dim, device_type, dtype)


# --------------------------------------------------------------------------
# The tracer and its code generator


def _lit(v, f64: bool = False) -> str:
    """A float32 C++ literal of ``v``, exact; ``f64``: a double literal of
    ``v`` (no ``f`` suffix), for a float64 instance."""
    f = float(v) if f64 else float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    s = f.hex() + ("" if f64 else "f")
    return f"({s})" if f < 0 else s


def _strides(shape) -> list:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return out[::-1]


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _multi_index(shape, flat: str) -> list:
    """C++ expressions of the multi-index of the flat index ``flat`` into
    a row-major ``shape``."""
    st, total = _strides(shape), _numel(shape)
    out = []
    for n, s in zip(shape, st):
        if n == 1:
            out.append("0")
        elif s == 1 and n == total:
            out.append(flat)
        elif s == 1:
            out.append(f"({flat} % {n})")
        elif s * n == total:
            out.append(f"({flat} / {s})")
        else:
            out.append(f"({flat} / {s} % {n})")
    return out


def _flat(shape, idx: list) -> str:
    """The flat offset of the multi-index ``idx`` (broadcast: a size-1
    dim reads 0)."""
    terms = [i if s == 1 else f"{i} * {s}"
             for n, s, i in zip(shape, _strides(shape), idx)
             if n != 1 and i != "0"]
    return " + ".join(terms) if terms else "0"


@dataclasses.dataclass(frozen=True)
class _Var:
    """A chain-dependent value: ``name`` holds one chain's elements, a
    row-major array of ``shape`` (a scalar when it has one element). Not a
    tuple, so that a pytree walk sees it as one leaf. ``chain`` False: a
    value of a coordinate's tables alone (``[1, 1]`` in the trace), the
    same for every chain."""

    name: str
    shape: tuple
    chain: bool = True
    ctype: str = "S"


#: the C++ type of a value of each dtype in an int32 density's body
#: (value only, ``S`` is float there)
_INT_CTYPES = {torch.float32: "S", torch.int32: "int32_t",
               torch.bool: "bool"}


class _Gen:
    """One trace's code generator: the lines of ``logp``'s body and the
    constants it reads from ``params``. ``dtype``: the scalar of its
    floating values, float32 or float64 (a float64 instance's literals
    are doubles); ``ints``: an int32 density's body, whose values are
    float32, int32 or bool (``_INT_CTYPES``)."""

    def __init__(self, chains: int, offset: int, dtype=torch.float32,
                 ints: bool = False):
        self.chains = chains
        self.lines: list = []
        self.consts: list = []
        self.offset = offset
        self.dtype = dtype
        self.ints = ints
        #: the literal 1 of the scalar (float32's text is the one the
        #: float32 instances were always generated with)
        self.one = "1.0" if dtype == torch.float64 else "1.0f"
        self._const_off: dict = {}
        self._n = 0

    def lit(self, v) -> str:
        """A C++ literal of the number ``v``: an integer or a bool as such
        in an int32 body, else a float of the generator's scalar."""
        if self.ints and isinstance(v, (bool, int)):
            return ("true" if v else "false") if isinstance(v, bool) else (
                str(int(v)))
        return _lit(v, self.dtype == torch.float64)

    def ctype(self, node) -> str:
        """The C++ type of ``node``'s value; raises for a dtype the body
        cannot hold (anything but the scalar, and int32 and bool in an
        int32 body)."""
        val = node.meta.get("val")
        dt = getattr(val, "dtype", None)
        if isinstance(val, torch.Tensor):
            if dt == self.dtype:
                return "S"
            if self.ints and dt in _INT_CTYPES:
                return _INT_CTYPES[dt]
        name = getattr(node.target, "_opname", str(node.target))
        overload = getattr(node.target, "_overloadname", "")
        self.fail(node, f"{name}.{overload} gives "
                        f"{dt if dt is not None else type(val).__name__}, "
                        f"not a {str(self.dtype).replace('torch.', '')} "
                        "tensor")

    def fail(self, node, why: str):
        raise ValueError(
            f"derive_logp_dc: {why} (node {node.name!r}, "
            f"{getattr(node.target, '__name__', node.target)}). Write the "
            "density's C++ as Target.cuda_source (csrc/user_density.cuh), "
            "or use use_pallas=False.")

    def chain_axis(self, node, what: str):
        self.fail(node, f"{what} touches the chain axis: each chain's "
                        "density must depend on that chain alone (the "
                        "cross-lane coupling of derive_grad_dc's contract)")

    # -- values --------------------------------------------------------
    def elem(self, v, out_full: tuple, idx: list) -> str:
        """The element of operand ``v`` (a _Var, a constant tensor or a
        Python number) at the per-chain multi-index ``idx`` of an output
        of full shape ``out_full`` (chain axis first), broadcast."""
        if isinstance(v, _Var):
            if _numel(v.shape) == 1:
                return v.name
            return f"{v.name}[{_flat(v.shape, idx)}]"
        if isinstance(v, torch.Tensor):
            if v.numel() == 1:
                return self.lit(v.reshape(()).item())
            lead = len(out_full) - v.dim()
            # const dim j <-> output dim lead + j <-> per-chain idx lead+j-1
            cidx = [idx[lead + j - 1] if lead + j >= 1 else "0"
                    for j in range(v.dim())]
            return f"__ldg(p_ + {self.const(v)} + {_flat(v.shape, cidx)})"
        return self.lit(v)

    def const(self, t: torch.Tensor) -> int:
        """The offset in ``params`` of constant ``t``, appended once."""
        if id(t) not in self._const_off:
            # the tensor is kept beside its offset, so its id stays its own
            self._const_off[id(t)] = (self.offset + len(self.consts), t)
            self.consts.extend(t.detach().cpu().double().reshape(-1).tolist())
        return self._const_off[id(t)][0]

    def lead(self, node, operands: list, what: str) -> bool:
        """Whether the node's value has the chain axis (``False``: its
        leading axis is a table's 1, every operand a table's value);
        raises for any other leading axis."""
        full = tuple(node.meta["val"].shape)
        if full and full[0] == self.chains:
            return True
        if (full and full[0] == 1 and not any(
                isinstance(v, _Var) and v.chain for v in operands)):
            return False
        self.chain_axis(node, what)

    def new(self, shape: tuple, declare: bool = True,
            chain: bool = True, ctype: str = "S") -> _Var:
        """A new value of ``shape``; ``declare``: its array now (a
        scalar is declared where it is first assigned)."""
        self._n += 1
        v = _Var(f"v{self._n}", tuple(shape), chain, ctype)
        if declare and _numel(shape) > 1:
            self.lines.append(f"{ctype} {v.name}[{_numel(shape)}];")
        return v

    def loop(self, out: _Var, body) -> None:
        """``out[i] = body(idx)`` over ``out``'s elements; ``body`` takes
        the per-chain multi-index (C++ expressions). An empty ``out``
        (numel 0) has no array and emits nothing."""
        n = _numel(out.shape)
        if n == 0:
            return
        if n == 1:
            self.lines.append(
                f"{out.ctype} {out.name} = {body(['0'] * len(out.shape))};")
            return
        self.lines.append("#pragma unroll")
        self.lines.append(f"for (int i = 0; i < {n}; ++i) "
                          f"{out.name}[i] = "
                          f"{body(_multi_index(out.shape, 'i'))};")

    # -- operations ----------------------------------------------------
    def pointwise(self, node, operands: list, fmt) -> _Var:
        """An elementwise operation of broadcast operands; ``fmt`` takes
        their element expressions."""
        full = tuple(node.meta["val"].shape)
        chain = self.lead(node, operands, "a broadcast")
        for v in operands:
            if isinstance(v, _Var) and len(v.shape) + 1 != len(full):
                self.chain_axis(node, "a broadcast")
            if (isinstance(v, torch.Tensor) and v.dim() == len(full)
                    and v.shape[0] != 1):
                self.chain_axis(node, "a constant over the chains")
        out = self.new(full[1:], chain=chain, ctype=self.ctype(node))
        self.loop(out, lambda idx: fmt(*(self.elem(v, full, idx)
                                         for v in operands)))
        return out

    def gather(self, node, src: _Var, index_of) -> _Var:
        """A copy of ``src`` into the node's shape, element ``idx`` from
        ``src`` at ``index_of(idx)`` (select, slice, expand)."""
        chain = self.lead(node, [src], "a copy")
        out = self.new(tuple(node.meta["val"].shape)[1:], chain=chain,
                       ctype=self.ctype(node))
        self.loop(out, lambda idx: self.elem(src, (0,) + src.shape,
                                             index_of(idx)))
        return out

    def reduce_sum(self, node, src: _Var, dims: list) -> _Var:
        full_in = (self.chains,) + src.shape
        dims = sorted({d % len(full_in) for d in dims} if dims
                      else range(len(full_in)))
        if 0 in dims:
            self.chain_axis(node, "a sum")
        red = [d - 1 for d in dims]
        kept = [k for k in range(len(src.shape)) if k not in red]
        red_shape = tuple(src.shape[k] for k in red)
        out = self.new(tuple(node.meta["val"].shape)[1:], chain=src.chain)
        kept_shape = tuple(src.shape[k] for k in kept)
        n_red = _numel(red_shape)

        def at(flat_out: str, flat_red: str) -> str:
            ko = _multi_index(kept_shape, flat_out)
            ro = _multi_index(red_shape, flat_red)
            idx = ["0"] * len(src.shape)
            for k, e in zip(kept, ko):
                idx[k] = e
            for k, e in zip(red, ro):
                idx[k] = e
            return self.elem(src, full_in, idx)

        n_out = _numel(out.shape)
        if n_red == 0 or n_out == 0:  # a sum over an empty extent is 0
            self.loop(out, lambda idx: "S(0)")
            return out
        if n_out == 1:
            self.lines.append(f"S {out.name} = {at('0', '0')};")
            if n_red > 1:
                self.lines += ["#pragma unroll",
                               f"for (int r = 1; r < {n_red}; ++r) "
                               f"{out.name} = {out.name} + {at('0', 'r')};"]
            return out
        self.lines += ["#pragma unroll",
                       f"for (int i = 0; i < {n_out}; ++i) {{",
                       f"  {out.name}[i] = {at('i', '0')};"]
        if n_red > 1:
            self.lines += ["#pragma unroll",
                           f"  for (int r = 1; r < {n_red}; ++r) "
                           f"{out.name}[i] = {out.name}[i] + {at('i', 'r')};"]
        self.lines.append("}")
        return out

    def matmul(self, node, a: _Var, w: torch.Tensor) -> _Var:
        """``a @ w``: a chain's row against a constant ``[K]`` or
        ``[K, M]``."""
        k = a.shape[-1]
        out = self.new(tuple(node.meta["val"].shape)[1:], chain=a.chain)
        m = 1 if w.dim() == 1 else w.shape[1]
        if k == 0 or _numel(out.shape) == 0:  # an empty contraction is 0
            self.loop(out, lambda idx: "S(0)")
            return out
        off = self.const(w)
        row = (lambda j: f"{a.name}[{j}]") if _numel(a.shape) > 1 else (
            lambda j: a.name)
        if m == 1:
            self.lines.append(f"S {out.name} = {row('0')} * "
                              f"__ldg(p_ + {off});")
            self.lines += ["#pragma unroll",
                           f"for (int r = 1; r < {k}; ++r) {out.name} = "
                           f"{out.name} + {row('r')} * "
                           f"__ldg(p_ + {off} + r * {m});"]
            return out
        self.lines += ["#pragma unroll",
                       f"for (int i = 0; i < {m}; ++i) {{",
                       f"  {out.name}[i] = {row('0')} * "
                       f"__ldg(p_ + {off} + i);",
                       "#pragma unroll",
                       f"  for (int r = 1; r < {k}; ++r) {out.name}[i] = "
                       f"{out.name}[i] + {row('r')} * "
                       f"__ldg(p_ + {off} + r * {m} + i);",
                       "}"]
        return out


_UNARY = {"exp": "mm::exp", "log": "mm::log", "log1p": "mm::log1p",
          "expm1": "mm::expm1", "sqrt": "mm::sqrt", "tanh": "mm::tanh",
          "sin": "mm::sin", "cos": "mm::cos", "abs": "mm::abs"}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "_to_copy"}
_VIEWS = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze"}


def _pow(gen: _Gen, a: str, p) -> str:
    if p == 1:
        return a
    if p == 2:
        return f"({a} * {a})"
    if p == 3:
        return f"({a} * {a} * {a})"
    if p == -1:
        return f"({gen.one} / {a})"
    if p == 0.5:
        return f"mm::sqrt({a})"
    return f"mm::pow({a}, {gen.lit(float(p))})"


#: an int32 density's comparisons, logic and selects (value only)
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_LOGIC = {"logical_or": "||", "bitwise_or": "||", "logical_and": "&&",
          "bitwise_and": "&&"}


def _emit(gen: _Gen, node, env: dict):
    """One aten node: a folded constant, an alias or code."""
    op = node.target
    name = getattr(op, "_opname", str(op))
    overload = getattr(op, "_overloadname", "")
    args = list(map_arg(node.args, lambda n: env[n.name]))
    kwargs = dict(map_arg(node.kwargs, lambda n: env[n.name]))
    if not any(isinstance(a, _Var) for a in tree_leaves((args, kwargs))):
        return op(*args, **kwargs)  # no chain in it: a constant
    val = node.meta.get("val")
    ctype = gen.ctype(node)  # raises for a dtype the body cannot hold

    if name in _IDENTITY:
        src = args[0]
        if name == "_to_copy" and isinstance(src, _Var) and (
                src.ctype != ctype):
            if ctype != "S":
                gen.fail(node, f"a cast from {src.ctype} to {ctype}")
            return gen.pointwise(node, [src],
                                 lambda a: f"static_cast<S>({a})")
        if name == "_to_copy" and kwargs.get("dtype") not in (
                None, gen.dtype) and ctype == "S":
            gen.fail(node, "a cast away from "
                           f"{str(gen.dtype).replace('torch.', '')}")
        return src
    x = args[0]
    if name in _VIEWS:
        full = tuple(val.shape)
        chain = gen.lead(node, [x], name)
        if chain != x.chain or (name == "unsqueeze"
                                and args[1] % (len(x.shape) + 2) == 0):
            gen.chain_axis(node, name)
        return _Var(x.name, full[1:], chain, x.ctype)
    if name == "expand":
        full = tuple(val.shape)
        if len(full) != len(x.shape) + 1:
            gen.chain_axis(node, "expand")
        return gen.gather(node, x, lambda idx: idx)
    if name == "select":
        dim = args[1] % (len(x.shape) + 1)
        if dim == 0:
            gen.chain_axis(node, "select")
        index = args[2] % x.shape[dim - 1]

        def at(idx, d=dim - 1, i=index):
            return idx[:d] + [str(i)] + idx[d:]
        return gen.gather(node, x, at)
    if name == "slice":
        rank = len(x.shape) + 1
        dim = args[1] % rank if len(args) > 1 else 0
        size = gen.chains if dim == 0 else x.shape[dim - 1]
        start, end, step = (list(args[2:5]) + [None, None, 1])[:3]
        start, end, step = slice(start, end, step).indices(size)
        if dim == 0:
            if (start, end, step) != (0, size, 1):
                gen.chain_axis(node, "slice")
            return x

        def at(idx, d=dim - 1, a=start, s=step):
            e = idx[d] if s == 1 else f"{idx[d]} * {s}"
            return idx[:d] + [e if a == 0 else f"{a} + {e}"] + idx[d + 1:]
        return gen.gather(node, x, at)
    if name == "sum":
        if overload == "default":
            gen.chain_axis(node, "a sum over every axis")
        if kwargs.get("dtype") not in (None, gen.dtype):
            gen.fail(node, "a sum in another dtype")
        return gen.reduce_sum(node, x, list(args[1] or []))
    if name in ("mm", "mv"):
        if not isinstance(x, _Var) or not isinstance(args[1], torch.Tensor):
            gen.fail(node, f"{name} of anything but a chain's row and a "
                           "constant")
        return gen.matmul(node, x, args[1])
    if gen.ints:
        code = _int_body_node(gen, node, name, overload, args, ctype)
        if code is not None:
            return code
    if ctype != "S":
        gen.fail(node, f"aten.{name}.{overload} giving {ctype}")
    if name in _UNARY:
        f = _UNARY[name]
        return gen.pointwise(node, [x], lambda a: f"{f}({a})")
    if name == "neg":
        return gen.pointwise(node, [x], lambda a: f"(-{a})")
    if name == "reciprocal":
        return gen.pointwise(node, [x], lambda a: f"({gen.one} / {a})")
    if name == "square":
        return gen.pointwise(node, [x], lambda a: f"({a} * {a})")
    if name == "pow" and overload == "Tensor_Scalar":
        p = args[1]
        return gen.pointwise(node, [x], lambda a: _pow(gen, a, p))
    alpha = kwargs.get("alpha", 1)
    scaled = (lambda b: b) if alpha == 1 else (
        lambda b: f"({gen.lit(alpha)} * {b})")
    if name in ("add", "sub", "mul", "div", "rsub", "minimum", "maximum",
                "logaddexp"):
        if name == "div" and kwargs.get("rounding_mode") is not None:
            gen.fail(node, "a rounded division")
        fmt = {
            "add": lambda a, b: f"({a} + {scaled(b)})",
            "sub": lambda a, b: f"({a} - {scaled(b)})",
            "rsub": lambda a, b: f"({b} - {scaled(a)})",
            "mul": lambda a, b: f"({a} * {b})",
            "div": lambda a, b: f"({a} / {b})",
            "minimum": lambda a, b: f"mm::fmin({a}, {b})",
            "maximum": lambda a, b: f"mm::fmax({a}, {b})",
            "logaddexp": lambda a, b: f"mm::logaddexp({a}, {b})",
        }[name]
        return gen.pointwise(node, args[:2], fmt)
    gen.fail(node, f"aten.{name}.{overload} is outside the code "
                   "generator's table")


def _int_body_node(gen: _Gen, node, name: str, overload: str, args: list,
                   ctype: str):
    """The nodes only an int32 density's body takes (value only, floats
    at float32): comparisons to bool, ``||``/``&&`` of bools, ``where``
    (a select, ``-inf`` off the support) and ``lgamma`` (``mm::lgamma``,
    CUDA's ``lgammaf``: what ``torch.lgamma`` computes); ``None`` for any
    other node."""
    if name in _COMPARE:
        op = _COMPARE[name]
        return gen.pointwise(node, args[:2], lambda a, b: f"({a} {op} {b})")
    if name in _LOGIC and ctype == "bool":
        op = _LOGIC[name]
        return gen.pointwise(node, args[:2], lambda a, b: f"({a} {op} {b})")
    if name == "where" and overload == "self":
        return gen.pointwise(node, args[:3],
                             lambda c, a, b: f"({c} ? {a} : {b})")
    if name == "lgamma" and ctype == "S":
        return gen.pointwise(node, args[:1], lambda a: f"mm::lgamma({a})")
    return None


def derive_logp_dc(target, dim: int, device="cpu",
                   dtype=torch.float32) -> tuple:
    """The C++ source of ``target``'s density at ``dim``, generated from
    its batch form, and the ``cuda_params`` it reads: ``target``'s own,
    then the tensor constants of the trace. The counterpart of the JAX
    package's ``derive_logp_dc`` (``base.py:168-185``).

    ``target.batch_logp`` is traced with ``make_fx`` on a ``[R, dim]``
    input on ``device``, ``R`` unlike ``dim`` so that the axes are told
    apart. Each aten node becomes one chain's value: a small row-major
    array of the node's shape without the chain axis, written as a loop
    with broadcast indexing. Nodes that do not depend on the input fold to
    constants; tensor constants are read with ``__ldg`` from ``params``.
    The table: elementwise and broadcast ``+ - * /``, ``neg``, ``exp``,
    ``log``, ``log1p``, ``expm1``, ``sqrt``, ``pow`` by a number,
    ``tanh``, ``sin``, ``cos``, ``abs``, ``minimum``/``maximum``,
    ``logaddexp``, ``reciprocal`` and ``square``; ``select``, ``slice``, ``unsqueeze``,
    ``view``/``reshape`` and ``expand`` on the per-chain axes; ``sum``
    over them; ``mm``/``mv`` (``matmul``) of a chain's row against a
    constant. Any other operation raises ``ValueError`` naming it, and so
    does a reduction, index or reshape across the chain axis (one chain's
    density reading another's): write the C++ as ``Target.cuda_source``.

    ``dtype``: the states' dtype. float32 gives the source every kernel
    compiles; float64 traces the batch form at float64 for Kernel 1's
    float64 instance, its literals and constants doubles (``const double*
    p_``). int32 traces it on int32 states for the MH kernel, a
    value-only ``template <int D> float logp(const int32_t (&x)[D])``
    whose floats are float32 (``csrc/user_density.cuh``); its body adds
    the int32 to float32 cast, comparisons, ``|``/``&`` of bools,
    ``where`` (``-inf`` off the support) and ``lgamma`` to the table.
    """
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"user densities run in Kernels 1-4 at D <= "
                         f"{MAX_DIM}; got D={dim}")
    ints = dtype == torch.int32
    scalar = torch.float32 if ints else dtype
    chains = next(r for r in (7, 11, 13) if r != dim)
    x = torch.zeros((chains, dim), dtype=dtype, device=device)
    # x is the array const S (&)[D]: at D = 1 its one element is x[0]
    row = _Var("x[0]" if dim == 1 else "x", (dim,),
               ctype="int32_t" if ints else "S")
    gen, ret, body = _trace(target.batch_logp, (x,), (row,),
                            len(target.cuda_params), "batch_logp", scalar,
                            ints)
    head = f"// generated by derive_logp_dc from the batch form, D = {dim}"
    if ints:
        source = f"""{head}, int32 states
struct Density {{
  const float* p_;
  __device__ __forceinline__ explicit Density(const float* p) : p_(p) {{}}

  template <int D>
  __device__ __forceinline__ float logp(const int32_t (&x)[D]) const {{
    static_assert(D == {dim}, "traced at D = {dim}");
    using S = float;
{body}
    return {ret};
  }}
}};
"""
    else:
        real = "double" if dtype == torch.float64 else "float"
        source = f"""{head}{', float64' if real == 'double' else ''}
struct Density {{
  const {real}* p_;
  __device__ __forceinline__ explicit Density(const {real}* p) : p_(p) {{}}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {{
    static_assert(D == {dim}, "traced at D = {dim}");
{body}
    return {ret};
  }}
}};
"""
    rnd = float if dtype == torch.float64 else (lambda v: float(np.float32(v)))
    return source, tuple(float(v) for v in target.cuda_params) + tuple(
        rnd(v) for v in gen.consts)


def _trace(fn, inputs: tuple, variables: tuple, offset: int, what: str,
           dtype=torch.float32, ints: bool = False):
    """``fn`` traced by ``make_fx`` on ``inputs`` (each placeholder the
    matching value of ``variables``), written out one node at a time:
    ``(generator, returned expression, body lines)``. ``fn`` must return
    ``[R]`` for the ``R`` rows of the first input; ``dtype`` and ``ints``
    are the generator's (:class:`_Gen`)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    chains = inputs[0].shape[0]
    gm = make_fx(lambda *a: fn(*a))(*inputs)
    gen = _Gen(chains, offset, dtype, ints)
    env: dict = {}
    out = None
    placeholders = iter(variables)
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node.name] = next(placeholders)
        elif node.op == "get_attr":
            env[node.name] = getattr(gm, node.target)
        elif node.op == "call_function":
            env[node.name] = _emit(gen, node, env)
        elif node.op == "output":
            out = node.args[0]
            out = out[0] if isinstance(out, (tuple, list)) else out
        else:
            gen.fail(node, f"an FX {node.op} node")
    res = env[out.name]
    shape = tuple(out.meta["val"].shape)
    if shape != (chains,):
        raise ValueError(
            f"the code generator: {what} must return [C]; got {list(shape)}"
            f" for a {list(inputs[0].shape)} input")
    ret = (res.name if isinstance(res, _Var)
           else gen.lit(res.reshape(-1)[0].item()))
    body = "\n".join("    " + ln if not ln.startswith("#") else ln
                     for ln in gen.lines)
    return gen, ret, body


#: the most ``sep_form`` tables a coordinate functor reads
#: (``csrc/user_density.cuh:UserCoord``)
MAX_COORD_TABLES = 2


def derive_coord_dc(target, device="cpu") -> tuple:
    """The C++ of ``target``'s coordinate functor (``struct Coord``,
    ``csrc/user_density.cuh``) generated from its ``sep_forms()`` tile
    density, and the ``cuda_params`` it reads: ``target``'s own, then the
    trace's tensor constants. The counterpart of the JAX package's
    per-tile ``jax.vjp`` of ``tile_logp`` (``ops/pallas/hmc_bigd.py:
    134-167``): the kernel differentiates the term by dual numbers.

    ``tile_logp`` is traced on a single coordinate, an ``[R, 1]`` input
    and ``[1, 1]`` tables, each table read as the coordinate's entry
    ``t[j]``; a target without a ``sep_form`` traces its batch form at
    D = 1 (the JAX default, ``base.py:145-149``). The operations are
    :func:`derive_logp_dc`'s. More than ``MAX_COORD_TABLES`` tables raise.
    """
    tile_logp, tables = target.sep_forms()
    n = len(tables)
    if n > MAX_COORD_TABLES:
        raise ValueError(
            f"a coordinate functor reads at most {MAX_COORD_TABLES} "
            f"sep_form tables; the target has {n}")
    x = torch.zeros((7, 1), dtype=torch.float32, device=device)
    tabs = tuple(torch.ones((1, 1), dtype=torch.float32, device=device)
                 for _ in range(n))
    variables = (_Var("x", (1,)),) + tuple(
        _Var(f"t[{j}]", (1,), chain=False) for j in range(n))
    gen, ret, body = _trace(tile_logp, (x,) + tabs, variables,
                            len(target.cuda_params), "tile_logp")
    source = f"""// generated by derive_coord_dc from the tile form, {n} tables
struct Coord {{
  static constexpr int kTables = {n};
  const float* p_;
  __device__ __forceinline__ explicit Coord(const float* p) : p_(p) {{}}

  template <class S>
  __device__ __forceinline__ S logp(S x,
                                    const mm::CoordTables<kTables>& t) const {{
{body}
    return {ret};
  }}
}};
"""
    return source, tuple(float(v) for v in target.cuda_params) + tuple(
        float(np.float32(v)) for v in gen.consts)


class CoordForms(NamedTuple):
    """What Kernel 7 compiles for a target (:func:`coord_forms`):
    ``source`` the ``Coord`` functor's C++, ``params`` every float it
    reads, ``n_tables`` its tables, ``traced`` whether it was generated."""

    source: str
    params: tuple
    n_tables: int
    traced: bool


def coord_forms(target, dim: int, device="cpu") -> CoordForms:
    """The coordinate functor Kernel 7 compiles for ``target`` (a metric's
    or a transform's wrapper around it included) at ``dim``: its
    ``cuda_coord_source``, or the one :func:`derive_coord_dc` traces from
    the tile form of the target it wraps (``cuda_base``) or of itself. The
    params are the functor's own (past a wrapper's tables,
    ``_build.wrapper_floats``), then a trace's constants."""
    base = coord_base(target)
    n = len(base.sep_forms()[1])
    own = tuple(target.cuda_params)[_build.wrapper_floats(target, dim):]
    if target.cuda_coord_source is not None:
        if n > MAX_COORD_TABLES:
            raise ValueError(
                f"a coordinate functor reads at most {MAX_COORD_TABLES} "
                f"sep_form tables; the target has {n}")
        return CoordForms(target.cuda_coord_source, own, n, False)
    source, traced = _coord_traced(base, torch.device(device).type)
    return CoordForms(source, own + traced[len(own):], n, True)


def coord_base(target):
    """The target whose tile form gives ``target``'s coordinate functor:
    the one a metric or a transform wraps (``cuda_base``), or ``target``
    itself. Raises for a wrapper around a density source without a
    coordinate source, whose tile form it does not keep."""
    wrapped = target.cuda_affine or target.cuda_transform is not None
    if wrapped and target.cuda_base is None:
        raise ValueError(
            "the separable kernel runs a metric's or a transform's wrapper "
            "around a target with a cuda_source only when that target "
            "also gives Target.cuda_coord_source")
    return target.cuda_base or target


@functools.lru_cache(maxsize=64)
def _coord_traced(base, device_type: str):
    return derive_coord_dc(base, device_type)


# --------------------------------------------------------------------------
# Per-density libraries


def instance_type(dim: int, flags: int, scalar: str = "float") -> str:
    """The C++ type of the instance of ``mm::User<Density>`` at ``dim``
    under the wrapper bits ``flags`` (``_build.instance_flags``);
    ``scalar`` ``"double"``: Kernel 1's float64 instance,
    ``mm::UserS<Density, double>``."""
    t = ("mm::User<mm_user::Density>" if scalar == "float"
         else f"mm::UserS<mm_user::Density, {scalar}>")
    if flags & 2:
        t = f"mm::Transformed<{t}, {dim}>"
    if flags & 1:
        wrap = "mm::WhitenedDiag" if flags & 4 else "mm::Whitened"
        t = f"{wrap}<{t}, {dim}>"
    return t


_ENTRIES = {
    "leapfrog": ("hmc_leapfrog.cuh", """
extern "C" int mm_leapfrog_f32(const void* pos, const void* mom,
    const void* grad, const void* eps, const void* params, int n_leapfrog,
    int n_chains, int dim, int target, int affine, int aligned,
    void* pos_out, void* mom_out, void* logp_out, void* grad_out,
    void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || affine != kFlags) return (int)cudaErrorInvalidValue;
  const mm::LeapfrogArgs a{pos, mom, grad, eps, params, n_leapfrog,
                           n_chains, aligned, pos_out, mom_out, logp_out,
                           grad_out, stream};
  return mm::launch_leapfrog<Inst, kDim>(a);
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__global__ void probe_kernel(const float* __restrict__ x, int rows,
                             const float* __restrict__ params,
                             float* __restrict__ logp,
                             float* __restrict__ grad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const Inst t(params);
  logp[r] = mm::probe_row<Inst, kDim>(t, x + (long long)r * kDim,
                                      grad + (long long)r * kDim);
}

// the instance's logp and gradient at `rows` states [rows, D]; returns
// the CUDA error.
extern "C" int mm_user_probe(const void* x, int rows, const void* params,
                             void* logp, void* grad, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  probe_kernel<<<mm::blocks_for(rows), mm::kThreads, 0,
                 (cudaStream_t)stream>>>((const float*)x, rows,
                                         (const float*)params,
                                         (float*)logp, (float*)grad);
  return (int)cudaGetLastError();
}
"""),
    "multistep": ("hmc_multistep.cuh", """
extern "C" int mm_hmc_multistep_f32(const void* pos, const void* logp,
    const void* grad, const void* eps, const void* params, int k_steps,
    int n_leapfrog, int n_chains, int dim, int target, int affine,
    uint32_t chain0, uint32_t seed_lo, uint32_t seed_hi, uint32_t step0,
    void* pos_out, void* logp_out, void* grad_out, void* hist,
    long long hist_sk, long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || affine != kFlags) return (int)cudaErrorInvalidValue;
  const mm::MultistepArgs a{pos, logp, grad, eps, params, k_steps,
                            n_leapfrog, n_chains, chain0, seed_lo, seed_hi,
                            step0, pos_out, logp_out, grad_out, hist,
                            hist_sk, hist_sc, stream};
  return mm::launch_multistep<Inst, kDim>(a);
}
"""),
    "subtree": ("nuts_subtree.cuh", """
extern "C" int mm_nuts_subtree_f32(const void* pos, const void* mom,
    const void* grad, const void* logu, const void* v, const void* eps,
    const void* joint0, const void* active, const void* params, int j,
    int max_depth, int32_t seed0, int32_t seed1, uint32_t chain0,
    int n_chains, int dim, int target, int affine, void* end_pos,
    void* end_mom, void* end_grad, void* prop_pos, void* prop_grad,
    void* prop_logp, void* n, void* s, void* alpha, void* n_alpha,
    void* diverged, int device, int* grid, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (j < 0 || j > max_depth || max_depth > mm::kMaxDepth ||
      dim != kDim || affine != kFlags)
    return (int)cudaErrorInvalidValue;
  const mm::SubtreeArgs a{pos, mom, grad, logu, v, eps, joint0, active,
                          params, j, max_depth, seed0, seed1, chain0,
                          n_chains, end_pos, end_mom, end_grad, prop_pos,
                          prop_grad, prop_logp, n, s, alpha, n_alpha,
                          diverged, device, grid, stream};
  return mm::launch_subtree<Inst, kDim>(a);
}
"""),
    "step": ("nuts_full.cuh", """
extern "C" int mm_nuts_step_f32(const void* pos, const void* eps,
    const void* params, int depth_limit, int max_depth, uint32_t k0,
    uint32_t k1, uint32_t step, uint32_t chain0, int n_chains, int dim,
    int target, int affine, void* counter, int blocks, void* stats,
    void* pos_out, void* alpha, void* n_alpha, void* diverged, void* depth,
    int device, int* grid, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (depth_limit < 0 || depth_limit > max_depth ||
      max_depth > mm::kMaxDepth || counter == nullptr || dim != kDim ||
      affine != kFlags)
    return (int)cudaErrorInvalidValue;
  const mm::StepArgs a{pos, eps, params, depth_limit, k0, k1, step, chain0,
                       n_chains, blocks, counter, stats, pos_out, alpha,
                       n_alpha, diverged, depth, device, grid, stream};
  return mm::launch_step<Inst, kDim>(a);
}
"""),
}


#: Kernel 1's float64 entry and the probe at double, the one unit of a
#: float64 density library (the JAX package runs float64 through its
#: Kernel 1 alone)
_F64_ENTRIES = {
    "leapfrog": ("hmc_leapfrog.cuh", """
extern "C" int mm_leapfrog_f64(const void* pos, const void* mom,
    const void* grad, const void* eps, const void* params, int n_leapfrog,
    int n_chains, int dim, int target, int affine, int aligned,
    void* pos_out, void* mom_out, void* logp_out, void* grad_out,
    void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || affine != kFlags) return (int)cudaErrorInvalidValue;
  const mm::LeapfrogArgs a{pos, mom, grad, eps, params, n_leapfrog,
                           n_chains, aligned, pos_out, mom_out, logp_out,
                           grad_out, stream};
  return mm::launch_leapfrog<Inst, kDim>(a);
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__global__ void probe_kernel(const double* __restrict__ x, int rows,
                             const double* __restrict__ params,
                             double* __restrict__ logp,
                             double* __restrict__ grad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const Inst t(params);
  logp[r] = mm::probe_row<Inst, kDim>(t, x + (long long)r * kDim,
                                      grad + (long long)r * kDim);
}

// the instance's logp and gradient at `rows` states [rows, D], float64;
// returns the CUDA error.
extern "C" int mm_user_probe(const void* x, int rows, const void* params,
                             void* logp, void* grad, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  probe_kernel<<<mm::blocks_for(rows), mm::kThreads, 0,
                 (cudaStream_t)stream>>>((const double*)x, rows,
                                         (const double*)params,
                                         (double*)logp, (double*)grad);
  return (int)cudaGetLastError();
}
"""),
}

_FLOAT_KEYWORD = re.compile(r"\bfloat\b")


#: ahead of a float64 instance's source: its ``mm::`` is ``mm::f64``, the
#: functions at double (``csrc/user_density.cuh``)
F64_MATH = "namespace mm = ::mm::f64;\n"


def as_double(source: str) -> str:
    """A density source as a float64 instance compiles it: each ``float``
    keyword read as ``double`` (the params pointer, the gradient, the
    locals), pasted after :data:`F64_MATH`. An ``f``-suffixed literal
    stays a float constant."""
    return _FLOAT_KEYWORD.sub("double", source)


def _unit(text: str, header: str, prelude: str) -> str:
    """A generated translation unit: the headers, the user's C++ pasted
    in ``namespace mm_user`` (``text``), then ``prelude`` (the instance's
    constants and types) in an unnamed namespace."""
    return f"""// generated by mini_mcmc_torch/ops/kernels/user_density.py
#include <cuda_runtime.h>
#include <stdint.h>

#include "user_density.cuh"
#include "hmc_common.cuh"
#include "targets.cuh"
#include "coord_targets.cuh"
#include "proposals.cuh"
#include "conditionals.cuh"
#include "{header}"

namespace mm_user {{
{text}
}}  // namespace mm_user

namespace {{
{prelude}
}}  // namespace
"""


def _pasted(source: str, name: str = "cuda_source") -> str:
    """A user source as pasted: compile errors name ``name`` and its
    lines."""
    return f'#line 1 "{name}"\n{source}\n'


def _density_unit(source: str, dim: int, flags: int, header: str,
                  scalar: str = "float") -> str:
    return _unit(_pasted(source), header, f"""constexpr int kDim = {dim};
constexpr int kFlags = {flags};
using Inst = {instance_type(dim, flags, scalar)};""")


_ERROR_STRING = """
extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""

# The value-only table (Kernels 5 and 8, which read a density's value
# alone): Target and Proposal are the instance's types, a built-in
# functor's or the user's (User<Density>, inside Transformed under a
# transform; mm_user::Proposal).
_VALUE_ENTRIES = {
    "mh": ("mh_multistep.cuh", """
extern "C" int mm_mh_multistep(const void* pos, const void* logp,
    const void* tparams, const void* pparams, int k_steps, int n_chains,
    int dim, int target, int proposal, int state_type, int transformed,
    uint32_t chain0, uint32_t seed_lo, uint32_t seed_hi, uint32_t step0,
    void* pos_out, void* logp_out, void* hist, long long hist_sk,
    long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || state_type != mm::kF32 || transformed != kTransformed)
    return (int)cudaErrorInvalidValue;
  const mm::MhArgs a{pos,     logp,    tparams, pparams,  k_steps,
                     n_chains, chain0, seed_lo, seed_hi,  step0,
                     pos_out, logp_out, hist,   hist_sk,  hist_sc, stream};
  return mm::launch_mh<Target, Proposal, float, kDim>(a);
}
""" + _ERROR_STRING),
    "pt": ("pt_multistep.cuh", """
extern "C" int mm_pt_multistep(const void* pos, const void* logp,
    const void* sa, const void* tparams, const void* ladder, int n_chains,
    int dim, int n_temps, int k_steps, int n_inner, int target,
    int transformed, int parity0, uint32_t chain0, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t step0, void* pos_out, void* logp_out,
    void* sa_out, void* hist, long long hist_sk, long long hist_sc,
    void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || transformed != kTransformed)
    return (int)cudaErrorInvalidValue;
  const mm::PtArgs a{pos,      logp,    sa,      tparams, ladder,
                     n_chains, n_temps, k_steps, n_inner, parity0,
                     chain0,   seed_lo, seed_hi, step0,   pos_out, logp_out,
                     sa_out,   hist,    hist_sk, hist_sc, stream};
  return mm::launch_pt<Target, kDim>(a);
}
"""),
    "probe": ("philox.cuh", """
__global__ void value_probe_kernel(const float* __restrict__ x, int rows,
                                   const float* __restrict__ params,
                                   float* __restrict__ logp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Target t(params);
  if (r >= rows) return;
  float xr[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) xr[d] = x[(long long)r * kDim + d];
  logp[r] = t.template logp<kDim>(xr);
}

__global__ void propose_probe_kernel(const float* __restrict__ x,
                                     const uint32_t* __restrict__ w,
                                     int rows,
                                     const float* __restrict__ params,
                                     float* __restrict__ y) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Proposal q(params);
  if (r >= rows) return;
  float xr[kDim], yr[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) xr[d] = x[(long long)r * kDim + d];
  q.template propose<kDim>(xr, w + (long long)r * kPropWords, yr);
#pragma unroll
  for (int d = 0; d < kDim; ++d) y[(long long)r * kDim + d] = yr[d];
}

// the instance's logp at `rows` states [rows, D]; returns the CUDA error
extern "C" int mm_user_probe_value(const void* x, int rows,
                                   const void* params, void* logp,
                                   void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  value_probe_kernel<<<mm::blocks_for(rows), mm::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, rows, (const float*)params, (float*)logp);
  return (int)cudaGetLastError();
}

// the proposal from `rows` states [rows, D] on their words [rows, W]
// (W = words<D>(), which `n_words` must equal) into y [rows, D]
extern "C" int mm_user_propose_probe(const void* x, const void* words,
                                     int rows, int n_words,
                                     const void* params, void* y,
                                     void* stream) {
  if (n_words != kPropWords) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  propose_probe_kernel<<<mm::blocks_for(rows), mm::kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)words, rows, (const float*)params,
      (float*)y);
  return (int)cudaGetLastError();
}
"""),
}

#: the int32 state's words in the value-only entries (Kernel 5's int32
#: instances and their probes): (float32 text, int32 text, count)
_INT32_TEXT = {
    "mh": (("state_type != mm::kF32", "state_type != mm::kI32", 1),
           ("launch_mh<Target, Proposal, float, kDim>",
            "launch_mh<Target, Proposal, int32_t, kDim>", 1)),
    "probe": (("const float* __restrict__ x,", "const int32_t* __restrict__ x,",
               2),
              ("float xr[kDim];", "int32_t xr[kDim];", 1),
              ("float xr[kDim], yr[kDim];", "int32_t xr[kDim], yr[kDim];", 1),
              ("float* __restrict__ y)", "int32_t* __restrict__ y)", 1),
              ("(const float*)x,", "(const int32_t*)x,", 2),
              ("(float*)y)", "(int32_t*)y)", 1)),
}


def _value_entry(name: str, pos: str) -> str:
    """The C entries of value-only unit ``name`` at state type ``pos``
    (``"float"``, or ``"int32_t"``: :data:`_INT32_TEXT`)."""
    text = _VALUE_ENTRIES[name][1]
    if pos == "float":
        return text
    for old, new, count in _INT32_TEXT[name]:
        if text.count(old) != count:
            raise AssertionError(f"value entry {name}: {old!r}")
        text = text.replace(old, new)
    return text


_GIBBS_ENTRIES = {
    "gibbs": ("gibbs_multistep.cuh", """
extern "C" int mm_gibbs_multistep(const void* pos, const void* params,
    int k_steps, int n_chains, int dim, int conditional, uint32_t chain0,
    uint32_t seed_lo, uint32_t seed_hi, uint32_t step0, void* pos_out,
    void* hist, long long hist_sk, long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim) return (int)cudaErrorInvalidValue;
  const mm::GibbsArgs a{pos,     params,  k_steps, n_chains, chain0,
                        seed_lo, seed_hi, step0,   pos_out,  hist,
                        hist_sk, hist_sc, stream};
  return mm::launch_gibbs<mm_user::Conditional, kDim>(a);
}
""" + _ERROR_STRING),
    "probe": ("philox.cuh", """
__global__ void sample_probe_kernel(const float* __restrict__ x,
                                    const uint32_t* __restrict__ w,
                                    int rows,
                                    const float* __restrict__ params,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const mm_user::Conditional cond(params);
  float s[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) s[d] = x[(long long)r * kDim + d];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    s[i] = cond.template sample<kDim>(i, s, w + (long long)r * kWords);
  }
#pragma unroll
  for (int d = 0; d < kDim; ++d) out[(long long)r * kDim + d] = s[d];
}

// one sweep from `rows` states [rows, D] on their words [rows, W] (W =
// words<D>(), which `n_words` must equal) into out [rows, D]
extern "C" int mm_user_sample_probe(const void* x, const void* words,
                                    int rows, int n_words,
                                    const void* params, void* out,
                                    void* stream) {
  if (n_words != kWords) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  sample_probe_kernel<<<mm::blocks_for(rows), mm::kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)words, rows, (const float*)params,
      (float*)out);
  return (int)cudaGetLastError();
}
"""),
}

_SEP_ENTRIES = {
    "sep": ("hmc_separable.cuh", """
extern "C" int mm_hmc_separable(const void* pos, const void* mom_in,
    const void* eps, const void* params, const void* tables, const void* bij,
    const void* scale, int n_chains, int dim, int n_leapfrog, int functor,
    int flags, int threads, int vec, uint32_t chain0, uint32_t d0,
    uint32_t seed_lo, uint32_t seed_hi, uint32_t step, void* pos_out,
    void* mom_out, void* parts, void* stream) {
  if (flags != kFlags) return (int)cudaErrorInvalidValue;
  const mm::SepCall c{pos,      mom_in,  nullptr,  nullptr, eps,
                      params,   tables,  bij,      scale,   n_chains,
                      dim,      n_leapfrog, threads, vec,   chain0,
                      seed_lo,  seed_hi, step,     pos_out, mom_out,
                      parts,    nullptr, nullptr,  stream,  d0};
  return mm::sep_trajectory<Inst>(c);
}

extern "C" int mm_hmc_separable_step(const void* pos, const void* mom_in,
    const void* u_in, const void* logp_in, const void* eps,
    const void* params, const void* tables, const void* bij,
    const void* scale, int n_chains, int dim, int n_leapfrog, int functor,
    int flags, int threads, int vec, uint32_t chain0, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t step, void* pos_out, void* logp_out,
    void* alpha_out, void* stream) {
  if (flags != kFlags) return (int)cudaErrorInvalidValue;
  const mm::SepCall c{pos,      mom_in,  u_in,     logp_in, eps,
                      params,   tables,  bij,      scale,   n_chains,
                      dim,      n_leapfrog, threads, vec,   chain0,
                      seed_lo,  seed_hi, step,     pos_out, nullptr,
                      nullptr,  logp_out, alpha_out, stream};
  return mm::sep_step<Inst>(c);
}

extern "C" int mm_hmc_separable_clusters(int functor, int flags,
                                         int threads, int n_tiles,
                                         int* out) {
  *out = 0;
  if (flags != kFlags) return (int)cudaErrorInvalidValue;
  return mm::sep_clusters<Inst>(threads, n_tiles, out);
}
""" + _ERROR_STRING),
    "probe": ("philox.cuh", """
__global__ void coord_probe_kernel(const float* __restrict__ x,
                                   const float* __restrict__ t0,
                                   const float* __restrict__ t1,
                                   const float* __restrict__ bij,
                                   const float* __restrict__ scale, int n,
                                   const float* __restrict__ params,
                                   const float* __restrict__ consts,
                                   float* __restrict__ logp,
                                   float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  mm::coord_probe_at<Inst>(x, t0, t1, bij, scale, n, params, consts, i,
                           logp, grad);
}

// the instance's term and derivative at n coordinates x [n], each with
// its table entries t0, t1 [n], bijector code, offset and width bij
// [3, n] and scale [n] (read as far as the instance reads them); consts
// the six soft-saturation constants
extern "C" int mm_user_coord_probe(const void* x, const void* t0,
                                   const void* t1, const void* bij,
                                   const void* scale, int n,
                                   const void* params, const void* consts,
                                   void* logp, void* grad, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  coord_probe_kernel<<<mm::blocks_for(n), mm::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t0, (const float*)t1,
      (const float*)bij, (const float*)scale, n, (const float*)params,
      (const float*)consts, (float*)logp, (float*)grad);
  return (int)cudaGetLastError();
}
"""),
}


class Spec(NamedTuple):
    """A per-form library: its user C++ (``source``, pasted in ``namespace
    mm_user``), D (0: any), wrapper bits and ``kind``: ``"density"``
    (Kernels 1-4 and ``mm_user_probe``, ``instance_flags`` bits; ``types``
    ``("double",)``: Kernel 1's float64 instance and the probe at double
    alone, the source read by :func:`as_double`),
    ``"value"`` (Kernels 5 and 8 and the value and proposal probes;
    ``types`` the target's and the proposal's C++ types, bit 1 a
    transform; a third type ``"int32_t"``: int32 states, Kernel 5 and
    the probes alone), ``"gibbs"`` (Kernel 6 and the sweep probe) or
    ``"sep"``
    (Kernel 7's three entries and the coordinate probe, any D; bits 1 a
    diagonal metric, 2 a transform). Every field is part of the library's
    name."""

    source: str
    dim: int
    flags: int
    kind: str = "density"
    types: tuple = ()


def _sep_inst(flags: int) -> str:
    coord = "mm::UserCoord<mm_user::Coord>"
    if flags & 2:
        return f"mm::TransformedCoord<{coord}, {'true' if flags & 1 else 'false'}>"
    return f"mm::Scaled<{coord}>" if flags & 1 else coord


def library_sources(source: str, dim: int, flags: int, kind: str = "density",
                    types: tuple = ()) -> dict:
    """The generated translation units of a per-form library
    (:class:`Spec`), by name."""
    if kind == "density" and types == ("double",):
        text = F64_MATH + _pasted(as_double(source))
        prelude = f"""constexpr int kDim = {dim};
constexpr int kFlags = {flags};
using Inst = {instance_type(dim, flags, "double")};"""
        return {name: _unit(text, header, prelude) + entry
                for name, (header, entry) in _F64_ENTRIES.items()}
    if kind == "density":
        return {name: _density_unit(source, dim, flags, header) + entry
                for name, (header, entry) in _ENTRIES.items()}
    if kind == "value":
        target, proposal = types[:2]
        pos = types[2] if len(types) > 2 else "float"
        if flags & 2:
            target = f"mm::Transformed<{target}, {dim}>"
        prelude = f"""constexpr int kDim = {dim};
constexpr int kTransformed = {flags >> 1 & 1};
using Target = {target};
using Proposal = {proposal};
constexpr int kPropWords = Proposal::template words<kDim>();"""
        names = ("mh", "pt", "probe") if (
            "mm_user::" in target and pos == "float") else ("mh", "probe")
        return {n: _unit(source, _VALUE_ENTRIES[n][0], prelude)
                + _value_entry(n, pos) for n in names}
    if kind == "gibbs":
        prelude = f"""constexpr int kDim = {dim};
constexpr int kWords = mm_user::Conditional::template words<kDim>();"""
        return {n: _unit(source, h, prelude) + e
                for n, (h, e) in _GIBBS_ENTRIES.items()}
    if kind == "sep":
        (n_tables,) = types
        prelude = f"""constexpr int kFlags = {flags};
using Coord = mm::UserCoord<mm_user::Coord>;
using Inst = {_sep_inst(flags)};
static_assert(mm_user::Coord::kTables == {n_tables},
              "Coord::kTables must be the sep_form's {n_tables} tables");"""
        return {n: _unit(source, h, prelude) + e
                for n, (h, e) in _SEP_ENTRIES.items()}
    raise ValueError(f"unknown library kind {kind!r}")


def library_path(source: str, dim: int, flags: int, kind: str = "density",
                 types: tuple = ()) -> Path:
    """Where :func:`lib_for` puts the library: its name hashes every field
    of its :class:`Spec`, its generated translation units, nvcc's flags
    and every header."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(f"{kind}:{dim}:{flags}:{types!r}\n".encode())
    for name, text in library_sources(source, dim, flags, kind,
                                      types).items():
        h.update(name.encode())
        h.update(text.encode())
    for p in sorted(_build.CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _build.BUILD_DIR / f"libmm_user_{h.hexdigest()[:16]}.so"


def jobs(requests) -> list:
    """The compile jobs (``_build.compile_libraries``) of the libraries of
    ``requests``, :class:`Spec` tuples (a ``(source, dim, flags)`` triple
    is a Kernels 1-4 library), that are not built yet, their translation
    units written to ``GEN_DIR``."""
    out = []
    for spec in map(lambda r: Spec(*r), requests):
        if spec.kind != "sep" and not 1 <= spec.dim <= MAX_DIM:
            raise ValueError(f"user forms run in the kernels at D <= "
                             f"{MAX_DIM}; got D={spec.dim}")
        so = library_path(*spec)
        if so.exists() or any(so == j[1] for j in out):
            continue
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        srcs = []
        for name, text in library_sources(*spec).items():
            path = GEN_DIR / f"{so.stem}_{name}.cu"
            path.write_text(text)
            srcs.append(path)
        out.append((srcs, so))
    return out


def build(requests) -> list:
    """Compile the libraries of ``requests`` (:func:`jobs`) that are not
    built yet: every translation unit of every one in its own ``nvcc``
    process, all started together. Returns their paths; raises
    ``RuntimeError`` with nvcc's output for a source that does not
    compile. The ``ptxas -v`` reports go to a ``.log`` beside each
    library, the seconds of its build to its first line."""
    _build.compile_libraries(jobs(requests))
    return [library_path(*r) for r in requests]


_SIGS = {
    "density": dict(_build.KERNEL_SIGS, mm_user_probe=[_P, _I, _P, _P, _P,
                                                       _P]),
    "density64": dict(_build.F64_SIGS, mm_user_probe=[_P, _I, _P, _P, _P,
                                                      _P]),
    "value": {"mm_mh_multistep": _build.ENTRY_SIGS["mm_mh_multistep"],
              "mm_user_probe_value": [_P, _I, _P, _P, _P],
              "mm_user_propose_probe": [_P, _P, _I, _I, _P, _P, _P]},
    "gibbs": {"mm_gibbs_multistep": _build.ENTRY_SIGS["mm_gibbs_multistep"],
              "mm_user_sample_probe": [_P, _P, _I, _I, _P, _P, _P]},
    "sep": {k: _build.ENTRY_SIGS[k] for k in (
        "mm_hmc_separable", "mm_hmc_separable_step",
        "mm_hmc_separable_clusters")} | {
        "mm_user_coord_probe": [_P] * 5 + [_I] + [_P] * 5},
}


@functools.lru_cache(maxsize=128)
def _load(path: str, kind: str = "density") -> ctypes.CDLL:
    handle = ctypes.CDLL(path)
    sigs = dict(_SIGS[kind])
    if kind == "value" and hasattr(handle, "mm_pt_multistep"):
        sigs["mm_pt_multistep"] = _build.ENTRY_SIGS["mm_pt_multistep"]
    return _build.bind(handle, sigs)


def lib_for(source: str, dim: int, flags: int, kind: str = "density",
            types: tuple = ()) -> ctypes.CDLL:
    """The loaded library of a :class:`Spec`, built first if need be
    (cached per process)."""
    spec = Spec(source, dim, flags, kind, types)
    (path,) = build([spec])
    return _load(str(path), "density64" if (kind, types) == (
        "density", ("double",)) else kind)


def density_spec(target, dim: int, device="cpu",
                 dtype=torch.float32) -> tuple:
    """``(Spec, params)`` of the density library Kernels 1-4 run for
    ``target`` at ``dim``: the float32 one, or at float64 Kernel 1's
    float64 instance (``types`` ``("double",)``)."""
    forms = dc_forms(target, dim, device, dtype)
    types = ("double",) if dtype == torch.float64 else ()
    return (Spec(forms.source, dim, _build.instance_flags(target),
                 "density", types), forms.params)


@functools.lru_cache(maxsize=64)
def _resolved(target, dim: int, device: torch.device, dtype=torch.float32):
    spec, params = density_spec(target, dim, device, dtype)
    handle = lib_for(*spec)
    params = torch.tensor(params or (0.0,), dtype=dtype, device=device)
    return handle, params


def kernel_lib(target, dim: int, device, dtype=torch.float32) -> tuple:
    """``(library, target id, params pointer)`` of a user target's
    instance for Kernels 1-4 at ``dtype`` (float64: Kernel 1's float64
    library; the id is unused: a library holds one)."""
    handle, params = _resolved(target, dim, torch.device(device), dtype)
    return handle, 0, params.data_ptr()


# --------------------------------------------------------------------------
# Kernels 5-8: user densities, proposals, conditionals and coordinate
# functors


#: the C++ types of the built-in functors that a user form's library
#: instantiates beside it (csrc/targets.cuh, csrc/proposals.cuh)
TARGET_TYPES = {"rosenbrock_nd": "mm::RosenbrockND",
                "gaussian2d": "mm::Gaussian2D",
                "gaussian_mixture_1d": "mm::GaussianMixture1D",
                "neal_funnel": "mm::NealFunnel"}
PROPOSAL_TYPES = {"isotropic_gaussian": "mm::IsotropicGaussian"}
#: the same at int32 states (Kernel 5's discrete instances)
INT_TARGET_TYPES = {"poisson": "mm::Poisson"}
INT_PROPOSAL_TYPES = {"random_walk_int": "mm::RandomWalkInt"}
_USER_DENSITY = "mm::User<mm_user::Density>"
#: an int32 user density runs as it is: its logp takes int32 states
_USER_INT_DENSITY = "mm_user::Density"


def source_of(form, kind: str) -> str:
    """``form.cuda_source``; raises for a form without one, naming the
    field (the JAX package derives neither a proposal nor a
    conditional: ``ops/mh.py:119-122``, ``ops/gibbs.py:57-60``)."""
    if form.cuda_source is None:
        raise ValueError(
            f"a {kind} without a built-in cuda_functor needs its C++ as "
            f"{kind}.cuda_source (csrc/{kind.lower()}s.cuh states the "
            "contract) to run in the CUDA kernel; use use_pallas=False")
    return form.cuda_source


def value_spec(target, proposal, dim: int, device="cpu",
               dtype=torch.float32) -> tuple:
    """``(Spec, target params)`` of Kernel 5's (and, for a float32 user
    density, Kernel 8's) library for ``target`` at ``dim`` under
    ``proposal`` (``None``: the isotropic walk, the library tempering
    runs) on states of ``dtype``: the user density's source or a built-in
    functor's type, the user proposal's source or a built-in one's type,
    bit 1 a transform. int32 states (``dtype`` ``torch.int32``) take the
    int32 forms (``INT_TARGET_TYPES``, ``INT_PROPOSAL_TYPES``, a source's
    int32 contract, ``csrc/user_density.cuh``), the third type
    ``"int32_t"``, and no transform. The params are the density's
    (``dc_forms``: a transform's table, its own, a trace's constants),
    ``None`` for a built-in functor's (``_build.params_ptr``). Raises for
    a form neither route runs."""
    transformed = _build.unwhitened(target, "the MH and tempering kernels")
    ints = dtype == torch.int32
    where = "int32" if ints else "float32"
    if ints and transformed:
        raise ValueError("an integer state takes no transform: the MH "
                         "kernel's int32 instances run no bijector")
    targets = INT_TARGET_TYPES if ints else TARGET_TYPES
    proposals = INT_PROPOSAL_TYPES if ints else PROPOSAL_TYPES
    text, params = "", None
    if target.cuda_functor is None:
        forms = dc_forms(target, dim, device, dtype)
        text += _pasted(forms.source)
        params = forms.params
        ttype = _USER_INT_DENSITY if ints else _USER_DENSITY
    elif target.cuda_functor in targets:
        if transformed and dim not in _build.KERNEL_DIMS:
            raise ValueError(
                f"a transformed built-in functor runs at D in "
                f"{_build.KERNEL_DIMS} (its bijector table rides in "
                f"cuda_params only there); got D={dim}")
        ttype = targets[target.cuda_functor]
    else:
        raise ValueError(
            f"Target.cuda_functor {target.cuda_functor!r} has no {where} "
            "instance beside a user proposal: the MH kernel takes "
            f"{sorted(targets)} on {where} states")
    if proposal is None or proposal.cuda_functor is not None:
        name = "isotropic_gaussian" if proposal is None else (
            proposal.cuda_functor)
        if name not in proposals:
            raise ValueError(
                f"Proposal.cuda_functor {name!r} has no {where} instance "
                f"beside a user density: the MH kernel takes "
                f"{sorted(proposals)} on {where} states")
        ptype = proposals[name]
    else:
        text += _pasted(source_of(proposal, "Proposal"),
                        "proposal cuda_source")
        ptype = "mm_user::Proposal"
    types = (ttype, ptype, "int32_t") if ints else (ttype, ptype)
    return Spec(text, dim, 2 * transformed, "value", types), params


@functools.lru_cache(maxsize=64)
def _value_resolved(target, proposal, dim: int, device: torch.device,
                    dtype=torch.float32):
    spec, params = value_spec(target, proposal, dim, device, dtype)
    handle = lib_for(*spec)
    tparams = None if params is None else torch.tensor(
        params or (0.0,), dtype=torch.float32, device=device)
    return handle, tparams


def value_lib(target, proposal, dim: int, device,
              dtype=torch.float32) -> tuple:
    """``(library, target params pointer)`` of the value-only library of
    :func:`value_spec` (built if need be); the pointer is ``None`` for a
    built-in functor, whose params the caller passes
    (``_build.params_ptr``)."""
    handle, tparams = _value_resolved(target, proposal, dim,
                                      torch.device(device), dtype)
    if tparams is None:
        return handle, _build.params_ptr(target, device)
    return handle, tparams.data_ptr()


def gibbs_spec(conditional, dim: int) -> Spec:
    """The :class:`Spec` of Kernel 6's library for a user conditional at
    ``dim``; raises for one without ``cuda_source``."""
    return Spec(_pasted(source_of(conditional, "Conditional")), dim, 0,
                "gibbs")


def sep_spec(target, flags: int, dim: int, device="cpu") -> tuple:
    """``(Spec, params)`` of Kernel 7's library for ``target``'s
    coordinate functor (:func:`coord_forms`) under the wrapper bits
    ``flags`` (1 a diagonal metric, 2 a transform); D-independent, the
    params the functor's at ``dim``. Raises past ``MAX_COORD_TABLES``
    tables, a scaled instance's scale included."""
    forms = coord_forms(target, dim, device)
    if flags == 1 and forms.n_tables + 1 > MAX_COORD_TABLES:
        raise ValueError(
            f"the separable kernel reads at most {MAX_COORD_TABLES} "
            f"tables: a diagonal metric's scale beside the functor's "
            f"{forms.n_tables}")
    return (Spec(_pasted(forms.source, "coord cuda_source"), 0, flags, "sep",
                 (forms.n_tables,)), forms.params)


@functools.lru_cache(maxsize=64)
def _sep_resolved(target, flags: int, dim: int, device: torch.device):
    spec, params = sep_spec(target, flags, dim, device)
    return lib_for(*spec), torch.tensor(params or (0.0,),
                                        dtype=torch.float32, device=device)


def sep_lib(target, flags: int, dim: int, device) -> tuple:
    """``(library, params pointer)`` of :func:`sep_spec`'s library, built
    if need be."""
    handle, params = _sep_resolved(target, flags, dim, torch.device(device))
    return handle, params.data_ptr()


def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` as a contiguous int32 tensor of the
    same bits, for a ``const uint32_t*``."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()


def _state_dtype(x: torch.Tensor, need_grad: bool = True):
    """The probe's state dtype for ``x``: int32 for integer states, float64
    for float64 ones where Kernel 1 runs them (``need_grad``), else
    float32."""
    if x.dtype in (torch.int32, torch.int64):
        return torch.int32
    if x.dtype == torch.float64 and need_grad:
        return torch.float64
    return torch.float32


def probe(target, x: torch.Tensor, need_grad: bool = True, proposal=None):
    """The compiled instance's ``(logp [R], grad [R, D])`` at the rows of
    ``x``, ``[R, D]`` float32 (or float64: Kernel 1's float64 instance,
    logp and gradient float64): on the card through the per-density
    library's ``mm_user_probe`` (building it if need be), on the CPU
    through the host build (:func:`host_probe_lib`). ``need_grad`` False
    (the value-only kernels, 5 and 8): the value-only library's
    ``mm_user_probe_value`` on the card, which builds no dual numbers,
    and ``grad`` is ``None``; the library is that of (``target``,
    ``proposal``), the one MH launches (``None``: the isotropic walk's,
    the one tempering launches); an int32 ``x`` probes Kernel 5's int32
    instance (a float32 logp)."""
    dtype = _state_dtype(x, need_grad)
    x = x.detach().to(dtype).contiguous()
    r, d = x.shape
    real = torch.float64 if dtype == torch.float64 else torch.float32
    logp = torch.empty((r,), dtype=real, device=x.device)
    if not need_grad:
        if x.is_cuda:
            handle, params = value_lib(target, proposal, d, x.device, dtype)
            _build.check(handle.mm_user_probe_value(
                x.data_ptr(), r, params, logp.data_ptr(),
                _build.stream_ptr(x.device)), handle)
            return logp, None
        forms = dc_forms(target, d, "cpu", dtype)
        flags = _build.instance_flags(target)
        ints = dtype == torch.int32
        handle = _host_load(_HOST_VALUE_UNIT.format(
            source=forms.source, dim=d,
            inst=_USER_INT_DENSITY if ints else instance_type(d, flags),
            pos="int32_t" if ints else "float"))
        params = np.asarray(forms.params or (0.0,), np.float32)
        handle.mm_user_probe_value_host(x.data_ptr(), r, params.ctypes.data,
                                        logp.data_ptr())
        return logp, None
    grad = torch.empty_like(x)
    if x.is_cuda:
        handle, params = _resolved(target, d, x.device, dtype)
        _build.check(handle.mm_user_probe(
            x.data_ptr(), r, params.data_ptr(), logp.data_ptr(),
            grad.data_ptr(), _build.stream_ptr(x.device)), handle)
        return logp, grad
    forms = dc_forms(target, d, "cpu", dtype)
    f64 = dtype == torch.float64
    handle = host_probe_lib(forms.source, d, _build.instance_flags(target),
                            "double" if f64 else "float")
    params = np.asarray(forms.params or (0.0,),
                        np.float64 if f64 else np.float32)
    handle.mm_user_probe_host(
        x.data_ptr(), r, params.ctypes.data, logp.data_ptr(),
        grad.data_ptr())
    return logp, grad


def propose_probe(proposal, x: torch.Tensor, words: torch.Tensor,
                  target) -> torch.Tensor:
    """The compiled user proposal's ``[R, D]`` proposal from the rows of
    ``x`` ``[R, D]`` (float32, or int32 for an int32 proposal) on
    ``words`` ``[R, W]`` (int64, ``W = proposal.cuda_words(D)``): on the
    card the probe entry of Kernel 5's library of (``target``, the
    proposal), on the CPU the host build of the proposal alone. Raises
    when the source's ``words<D>()`` is not ``cuda_words(D)``."""
    dtype = _state_dtype(x, need_grad=False)
    x = x.detach().to(dtype).contiguous()
    r, d = x.shape
    w = _as_u32(words[:, :proposal.cuda_words(d)])
    y = torch.empty_like(x)
    params = torch.tensor(tuple(proposal.cuda_params) or (0.0,),
                          dtype=torch.float32, device=x.device)
    if x.is_cuda:
        handle, _ = value_lib(target, proposal, d, x.device, dtype)
        code = handle.mm_user_propose_probe(
            x.data_ptr(), w.data_ptr(), r, w.shape[1], params.data_ptr(),
            y.data_ptr(), _build.stream_ptr(x.device))
    else:
        handle = _host_load(_HOST_PROPOSE_UNIT.format(
            source=source_of(proposal, "Proposal"), dim=d,
            pos="int32_t" if dtype == torch.int32 else "float"))
        code = handle.mm_user_propose_probe_host(
            x.data_ptr(), w.data_ptr(), r, w.shape[1], params.data_ptr(),
            y.data_ptr())
    _words_check(code, "Proposal", d, proposal.cuda_words(d),
                 handle if x.is_cuda else None)
    return y


def sample_probe(conditional, x: torch.Tensor,
                 words: torch.Tensor) -> torch.Tensor:
    """One sweep of the compiled user conditional from the rows of ``x``
    ``[R, D]`` on ``words`` ``[R, W]`` (``W = conditional.cuda_words(D)``),
    coordinate ``i = 0..D-1`` in order given the updated state, as Kernel
    6 sweeps: on the card the Gibbs library's probe entry, on the CPU the
    host build. Returns ``[R, D]``."""
    x = x.detach().to(torch.float32).contiguous()
    r, d = x.shape
    w = _as_u32(words[:, :conditional.cuda_words(d)])
    out = torch.empty_like(x)
    params = torch.tensor(tuple(conditional.cuda_params) or (0.0,),
                          dtype=torch.float32, device=x.device)
    if x.is_cuda:
        handle = lib_for(*gibbs_spec(conditional, d))
        code = handle.mm_user_sample_probe(
            x.data_ptr(), w.data_ptr(), r, w.shape[1], params.data_ptr(),
            out.data_ptr(), _build.stream_ptr(x.device))
    else:
        handle = _host_load(_HOST_SAMPLE_UNIT.format(
            source=source_of(conditional, "Conditional"), dim=d))
        code = handle.mm_user_sample_probe_host(
            x.data_ptr(), w.data_ptr(), r, w.shape[1], params.data_ptr(),
            out.data_ptr())
    _words_check(code, "Conditional", d, conditional.cuda_words(d),
                 handle if x.is_cuda else None)
    return out


def _words_check(code: int, kind: str, dim: int, n_words: int,
                 handle=None) -> None:
    if code == 1:  # cudaErrorInvalidValue, and the host build's refusal
        raise ValueError(
            f"the {kind}'s cuda_source reads another number of words at "
            f"D={dim} than {kind}.cuda_words({dim}) = {n_words}: the twin "
            "and the kernel would take the accept or the next draw from "
            "other words")
    if code:
        _build.check(code, handle)


def coord_probe(target, x: torch.Tensor):
    """The separable kernel's instance for ``target`` (its coordinate
    functor inside the target's metric and transform wrappers, the bits
    of ``hmc_sep.sep_instance``): each element's term and derivative at
    ``x`` ``[R, D]`` in the kernel's coordinates, coordinate d reading
    column d of the target's ``sep_forms()`` tables, its bijector and its
    scale, as Kernel 7 reads them: ``(logp [R, D], grad [R, D])``. On the
    card through Kernel 7's library's probe entry, on the CPU through the
    host build."""
    from .hmc_sep import _bij_table, sep_instance

    x = x.detach().to(torch.float32).contiguous()
    r, d = x.shape
    _, n_rows, flags = sep_instance(target)
    tables = [t.detach().to(x.device, torch.float32).reshape(d)
              for t in target.sep_forms()[1]]
    ones = torch.ones(d, dtype=torch.float32, device=x.device)

    def each(v):  # a [D] table as every element's entry
        return v.expand(r, d).contiguous()

    t0 = each(tables[0] if n_rows > 0 else ones)
    t1 = each(tables[1] if n_rows > 1 else ones)
    scale = each(tables[-1] if flags == 3 else ones)
    if flags & 2:
        full = _bij_table(target, x.device, 0, d)
        rows = full[:3 * d].reshape(3, 1, d).expand(3, r, d).contiguous()
        consts = full[3 * d:].contiguous()
    else:
        rows = torch.zeros((3, r, d), device=x.device)
        rows[2] = 1.0
        consts = torch.zeros(8, device=x.device)
    logp, grad = torch.empty_like(x), torch.empty_like(x)
    spec, params = sep_spec(target, flags, d, x.device)
    params = torch.tensor(params or (0.0,), dtype=torch.float32,
                          device=x.device)
    args = (x.data_ptr(), t0.data_ptr(), t1.data_ptr(), rows.data_ptr(),
            scale.data_ptr(), r * d, params.data_ptr(), consts.data_ptr(),
            logp.data_ptr(), grad.data_ptr())
    if x.is_cuda:
        handle = lib_for(*spec)
        _build.check(handle.mm_user_coord_probe(
            *args, _build.stream_ptr(x.device)), handle)
    else:
        handle = _host_load(_HOST_COORD_UNIT.format(
            source=spec.source, n_tables=spec.types[0],
            inst=_sep_inst(flags)))
        handle.mm_user_coord_probe_host(*args)
    return logp, grad


# --------------------------------------------------------------------------
# The host build, for the CPU tests


_HOST_HEAD = """// generated by mini_mcmc_torch/ops/kernels/user_density.py (host)
#include "host_shim.h"
#include "user_density.cuh"
#include "targets.cuh"
#include "proposals.cuh"
#include "conditionals.cuh"
#include "coord_targets.cuh"

namespace mm_user {{
#line 1 "cuda_source"
{source}
}}  // namespace mm_user
"""
_HOST_UNIT = _HOST_HEAD + """
using Inst = {inst};

extern "C" void mm_user_probe_host(const {real}* x, int rows,
                                   const {real}* params, {real}* logp,
                                   {real}* grad) {{
  const Inst t(params);
  for (int r = 0; r < rows; ++r) {{
    logp[r] = mm::probe_row<Inst, {dim}>(t, x + (long long)r * {dim},
                                         grad + (long long)r * {dim});
  }}
}}
"""
_HOST_VALUE_UNIT = _HOST_HEAD + """
using Inst = {inst};

extern "C" void mm_user_probe_value_host(const {pos}* x, int rows,
                                         const float* params, float* logp) {{
  const Inst t(params);
  for (int r = 0; r < rows; ++r) {{
    {pos} xr[{dim}];
    for (int d = 0; d < {dim}; ++d) xr[d] = x[(long long)r * {dim} + d];
    logp[r] = t.template logp<{dim}>(xr);
  }}
}}
"""
_HOST_PROPOSE_UNIT = _HOST_HEAD + """
extern "C" int mm_user_propose_probe_host(const {pos}* x,
                                          const uint32_t* w, int rows,
                                          int n_words, const float* params,
                                          {pos}* y) {{
  constexpr int kWords = mm_user::Proposal::template words<{dim}>();
  if (n_words != kWords) return 1;
  const mm_user::Proposal q(params);
  for (int r = 0; r < rows; ++r) {{
    {pos} xr[{dim}], yr[{dim}];
    for (int d = 0; d < {dim}; ++d) xr[d] = x[(long long)r * {dim} + d];
    q.template propose<{dim}>(xr, w + (long long)r * kWords, yr);
    for (int d = 0; d < {dim}; ++d) y[(long long)r * {dim} + d] = yr[d];
  }}
  return 0;
}}
"""
_HOST_SAMPLE_UNIT = _HOST_HEAD + """
extern "C" int mm_user_sample_probe_host(const float* x, const uint32_t* w,
                                         int rows, int n_words,
                                         const float* params, float* out) {{
  constexpr int kWords = mm_user::Conditional::template words<{dim}>();
  if (n_words != kWords) return 1;
  const mm_user::Conditional cond(params);
  for (int r = 0; r < rows; ++r) {{
    float s[{dim}];
    for (int d = 0; d < {dim}; ++d) s[d] = x[(long long)r * {dim} + d];
    for (int i = 0; i < {dim}; ++i) {{
      s[i] = cond.template sample<{dim}>(i, s, w + (long long)r * kWords);
    }}
    for (int d = 0; d < {dim}; ++d) out[(long long)r * {dim} + d] = s[d];
  }}
  return 0;
}}
"""
_HOST_COORD_UNIT = """// generated by mini_mcmc_torch/ops/kernels/user_density.py (host)
#include "host_shim.h"
#include "user_density.cuh"
#include "coord_targets.cuh"

namespace mm_user {{
{source}
}}  // namespace mm_user

using Coord = mm::UserCoord<mm_user::Coord>;
using Inst = {inst};
static_assert(mm_user::Coord::kTables == {n_tables},
              "Coord::kTables must be the sep_form's {n_tables} tables");

extern "C" void mm_user_coord_probe_host(const float* x, const float* t0,
                                         const float* t1, const float* bij,
                                         const float* scale, int n,
                                         const float* params,
                                         const float* consts, float* logp,
                                         float* grad) {{
  for (int i = 0; i < n; ++i) {{
    mm::coord_probe_at<Inst>(x, t0, t1, bij, scale, n, params, consts, i,
                             logp, grad);
  }}
}}
"""
#: the host units' entries and their argument types
_HOST_SIGS = {
    "mm_user_probe_host": ([_P, _I, _P, _P, _P], None),
    "mm_user_probe_value_host": ([_P, _I, _P, _P], None),
    "mm_user_propose_probe_host": ([_P, _P, _I, _I, _P, _P], _I),
    "mm_user_sample_probe_host": ([_P, _P, _I, _I, _P, _P], _I),
    "mm_user_coord_probe_host": ([_P] * 5 + [_I] + [_P] * 4, None),
}
#: g++ flags of the host build: IEEE float arithmetic, as nvcc's without
#: -use_fast_math, and no contraction into FMAs beyond what the card does
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def host_probe_lib(source: str, dim: int, flags: int = 0,
                   scalar: str = "float") -> ctypes.CDLL:
    """``source`` at ``dim`` under ``flags`` built for the host with
    ``g++`` and ``csrc/host_shim.h``: ``mm_user_probe_host(x, rows,
    params, logp, grad)`` evaluates the instance on host arrays of
    ``scalar`` (``"double"``: the float64 instance, the source read by
    :func:`as_double`). The CPU tests alone use it; a compile error
    raises with g++'s output."""
    if scalar == "double":
        source = (F64_MATH + '#line 1 "cuda_source"\n'
                  + as_double(source))
    text = _HOST_UNIT.format(source=source, dim=dim, real=scalar,
                             inst=instance_type(dim, flags, scalar))
    return _host_load(text)


@functools.lru_cache(maxsize=64)
def _host_load(text: str) -> ctypes.CDLL:
    """A host unit built with ``g++`` (cached by its text and the
    headers' in ``build/mini_mcmc_torch/``), its entries bound."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host build cannot be made")
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + text.encode())
    for p in sorted(_build.CSRC_DIR.glob("*.cuh")) + [
            _build.CSRC_DIR / "host_shim.h"]:
        h.update(p.read_bytes())
    so = _build.BUILD_DIR / f"libmm_user_host_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, src = tempfile.mkstemp(suffix=".cpp", dir=_build.BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        tmp = f"{src}.so"
        out = subprocess.run(
            [cxx, *HOST_FLAGS, "-x", "c++", "-I", str(_build.CSRC_DIR),
             "-o", tmp, src], capture_output=True, text=True)
        os.unlink(src)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed (code {out.returncode}):\n"
                               f"{out.stderr[-6000:]}")
        os.replace(tmp, so)
    handle = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _HOST_SIGS.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return handle
