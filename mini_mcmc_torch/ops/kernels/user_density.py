"""User densities inside Kernels 1-4: a Target's C++ compiled per density.

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


def dc_forms(target, dim: int, device="cpu") -> DcForms:
    """The C++ the kernels compile for ``target`` at ``dim``: its
    ``cuda_source``, or the one :func:`derive_logp_dc` traces from the
    batch form of the target it wraps (``cuda_base``) or of itself, the
    trace on ``device``."""
    if target.cuda_functor is not None:
        raise ValueError(
            f"Target.cuda_functor {target.cuda_functor!r} is built in "
            "(csrc/targets.cuh): it has no source to compile")
    params = tuple(target.cuda_params)
    if target.cuda_source is not None:
        return DcForms(target.cuda_source, params,
                       grad_kind(target.cuda_source), False)
    base = target.cuda_base or target
    source, traced = _traced(base, dim, torch.device(device).type)
    return DcForms(source, params + traced[len(base.cuda_params):],
                   "derived", True)


@functools.lru_cache(maxsize=64)
def _traced(base, dim: int, device_type: str):
    return derive_logp_dc(base, dim, device_type)


# --------------------------------------------------------------------------
# The tracer and its code generator


def _lit(v) -> str:
    """A float32 C++ literal of ``v``, exact."""
    f = float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    s = f.hex() + "f"
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
    tuple, so that a pytree walk sees it as one leaf."""

    name: str
    shape: tuple


class _Gen:
    """One trace's code generator: the lines of ``logp``'s body and the
    constants it reads from ``params``."""

    def __init__(self, chains: int, offset: int):
        self.chains = chains
        self.lines: list = []
        self.consts: list = []
        self.offset = offset
        self._const_off: dict = {}
        self._n = 0

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
                return _lit(v.reshape(()).item())
            lead = len(out_full) - v.dim()
            # const dim j <-> output dim lead + j <-> per-chain idx lead+j-1
            cidx = [idx[lead + j - 1] if lead + j >= 1 else "0"
                    for j in range(v.dim())]
            return f"__ldg(p_ + {self.const(v)} + {_flat(v.shape, cidx)})"
        return _lit(v)

    def const(self, t: torch.Tensor) -> int:
        """The offset in ``params`` of constant ``t``, appended once."""
        if id(t) not in self._const_off:
            # the tensor is kept beside its offset, so its id stays its own
            self._const_off[id(t)] = (self.offset + len(self.consts), t)
            self.consts.extend(t.detach().cpu().double().reshape(-1).tolist())
        return self._const_off[id(t)][0]

    def new(self, shape: tuple, declare: bool = True) -> _Var:
        """A new value of ``shape``; ``declare``: its array now (a
        scalar is declared where it is first assigned)."""
        self._n += 1
        v = _Var(f"v{self._n}", tuple(shape))
        if declare and _numel(shape) > 1:
            self.lines.append(f"S {v.name}[{_numel(shape)}];")
        return v

    def loop(self, out: _Var, body) -> None:
        """``out[i] = body(idx)`` over ``out``'s elements; ``body`` takes
        the per-chain multi-index (C++ expressions)."""
        n = _numel(out.shape)
        if n == 1:
            self.lines.append(
                f"S {out.name} = {body(['0'] * len(out.shape))};")
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
        if not full or full[0] != self.chains:
            self.chain_axis(node, "a broadcast")
        for v in operands:
            if isinstance(v, _Var) and len(v.shape) + 1 != len(full):
                self.chain_axis(node, "a broadcast")
            if (isinstance(v, torch.Tensor) and v.dim() == len(full)
                    and v.shape[0] != 1):
                self.chain_axis(node, "a constant over the chains")
        out = self.new(full[1:])
        self.loop(out, lambda idx: fmt(*(self.elem(v, full, idx)
                                         for v in operands)))
        return out

    def gather(self, node, src: _Var, index_of) -> _Var:
        """A copy of ``src`` into the node's shape, element ``idx`` from
        ``src`` at ``index_of(idx)`` (select, slice, expand)."""
        out = self.new(tuple(node.meta["val"].shape)[1:])
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
        out = self.new(tuple(node.meta["val"].shape)[1:])
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
        out = self.new(tuple(node.meta["val"].shape)[1:])
        m = 1 if w.dim() == 1 else w.shape[1]
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


def _pow(a: str, p) -> str:
    if p == 1:
        return a
    if p == 2:
        return f"({a} * {a})"
    if p == 3:
        return f"({a} * {a} * {a})"
    if p == -1:
        return f"(1.0f / {a})"
    if p == 0.5:
        return f"mm::sqrt({a})"
    return f"mm::pow({a}, {_lit(p)})"


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
    if not isinstance(val, torch.Tensor) or val.dtype != torch.float32:
        gen.fail(node, f"{name}.{overload} gives "
                       f"{getattr(val, 'dtype', type(val).__name__)}, not "
                       "a float32 tensor")

    if name in _IDENTITY:
        if name == "_to_copy" and kwargs.get("dtype", torch.float32) not in (
                None, torch.float32):
            gen.fail(node, "a cast away from float32")
        return args[0]
    x = args[0]
    if name in _VIEWS:
        full = tuple(val.shape)
        if not full or full[0] != gen.chains:
            gen.chain_axis(node, f"{name}")
        if name == "unsqueeze" and args[1] % (len(x.shape) + 2) == 0:
            gen.chain_axis(node, "unsqueeze")
        return _Var(x.name, full[1:])
    if name == "expand":
        full = tuple(val.shape)
        if not full or full[0] != gen.chains or len(full) != len(x.shape) + 1:
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
        if kwargs.get("dtype") not in (None, torch.float32):
            gen.fail(node, "a sum in another dtype")
        return gen.reduce_sum(node, x, list(args[1] or []))
    if name in ("mm", "mv"):
        if not isinstance(x, _Var) or not isinstance(args[1], torch.Tensor):
            gen.fail(node, f"{name} of anything but a chain's row and a "
                           "constant")
        return gen.matmul(node, x, args[1])
    if name in _UNARY:
        f = _UNARY[name]
        return gen.pointwise(node, [x], lambda a: f"{f}({a})")
    if name == "neg":
        return gen.pointwise(node, [x], lambda a: f"(-{a})")
    if name == "reciprocal":
        return gen.pointwise(node, [x], lambda a: f"(1.0f / {a})")
    if name == "square":
        return gen.pointwise(node, [x], lambda a: f"({a} * {a})")
    if name == "pow" and overload == "Tensor_Scalar":
        p = args[1]
        return gen.pointwise(node, [x], lambda a: _pow(a, p))
    alpha = kwargs.get("alpha", 1)
    scaled = (lambda b: b) if alpha == 1 else (
        lambda b: f"({_lit(alpha)} * {b})")
    if name in ("add", "sub", "mul", "div", "rsub", "minimum", "maximum"):
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
        }[name]
        return gen.pointwise(node, args[:2], fmt)
    gen.fail(node, f"aten.{name}.{overload} is outside the code "
                   "generator's table")


def derive_logp_dc(target, dim: int, device="cpu") -> tuple:
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
    ``reciprocal`` and ``square``; ``select``, ``slice``, ``unsqueeze``,
    ``view``/``reshape`` and ``expand`` on the per-chain axes; ``sum``
    over them; ``mm``/``mv`` (``matmul``) of a chain's row against a
    constant. Any other operation raises ``ValueError`` naming it, and so
    does a reduction, index or reshape across the chain axis (one chain's
    density reading another's): write the C++ as ``Target.cuda_source``.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"user densities run in Kernels 1-4 at D <= "
                         f"{MAX_DIM}; got D={dim}")
    chains = next(r for r in (7, 11, 13) if r != dim)
    x = torch.zeros((chains, dim), dtype=torch.float32, device=device)
    gm = make_fx(lambda p: target.batch_logp(p))(x)
    gen = _Gen(chains, len(target.cuda_params))
    env: dict = {}
    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node.name] = _Var("x", (dim,))
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
        raise ValueError(f"derive_logp_dc: batch_logp must return [C]; got "
                         f"{list(shape)} for a [{chains}, {dim}] input")
    ret = (res.name if isinstance(res, _Var)
           else _lit(res.reshape(-1)[0].item()))
    body = "\n".join("    " + ln if not ln.startswith("#") else ln
                     for ln in gen.lines)
    source = f"""// generated by derive_logp_dc from the batch form, D = {dim}
struct Density {{
  const float* p_;
  __device__ __forceinline__ explicit Density(const float* p) : p_(p) {{}}

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {{
    static_assert(D == {dim}, "traced at D = {dim}");
{body}
    return {ret};
  }}
}};
"""
    return source, tuple(float(v) for v in target.cuda_params) + tuple(
        float(np.float32(v)) for v in gen.consts)


# --------------------------------------------------------------------------
# Per-density libraries


def instance_type(dim: int, flags: int) -> str:
    """The C++ type of the instance of ``mm::User<Density>`` at ``dim``
    under the wrapper bits ``flags`` (``_build.instance_flags``)."""
    t = "mm::User<mm_user::Density>"
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
    int n_chains, int dim, int target, int affine, void* pos_out,
    void* mom_out, void* logp_out, void* grad_out, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || affine != kFlags) return (int)cudaErrorInvalidValue;
  const mm::LeapfrogArgs a{pos, mom, grad, eps, params, n_leapfrog,
                           n_chains, pos_out, mom_out, logp_out, grad_out,
                           stream};
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
    uint32_t seed_lo, uint32_t seed_hi, uint32_t step0, void* pos_out,
    void* logp_out, void* grad_out, void* hist, long long hist_sk,
    long long hist_sc, void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (dim != kDim || affine != kFlags) return (int)cudaErrorInvalidValue;
  const mm::MultistepArgs a{pos, logp, grad, eps, params, k_steps,
                            n_leapfrog, n_chains, seed_lo, seed_hi, step0,
                            pos_out, logp_out, grad_out, hist, hist_sk,
                            hist_sc, stream};
  return mm::launch_multistep<Inst, kDim>(a);
}
"""),
    "subtree": ("nuts_subtree.cuh", """
extern "C" int mm_nuts_subtree_f32(const void* pos, const void* mom,
    const void* grad, const void* logu, const void* v, const void* eps,
    const void* joint0, const void* active, const void* params, int j,
    int max_depth, int32_t seed0, int32_t seed1, int n_chains, int dim,
    int target, int affine, void* end_pos, void* end_mom, void* end_grad,
    void* prop_pos, void* prop_grad, void* prop_logp, void* n, void* s,
    void* alpha, void* n_alpha, void* diverged, int device, int* grid,
    void* stream) {
  if (n_chains <= 0) return (int)cudaSuccess;
  if (j < 0 || j > max_depth || max_depth > mm::kMaxDepth ||
      dim != kDim || affine != kFlags)
    return (int)cudaErrorInvalidValue;
  const mm::SubtreeArgs a{pos, mom, grad, logu, v, eps, joint0, active,
                          params, j, max_depth, seed0, seed1, n_chains,
                          end_pos, end_mom, end_grad, prop_pos, prop_grad,
                          prop_logp, n, s, alpha, n_alpha, diverged, device,
                          grid, stream};
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


def _density_unit(source: str, dim: int, flags: int, header: str) -> str:
    return f"""// generated by mini_mcmc_torch/ops/kernels/user_density.py
#include <cuda_runtime.h>
#include <stdint.h>

#include "user_density.cuh"
#include "targets.cuh"
#include "{header}"

namespace mm_user {{
#line 1 "cuda_source"
{source}
}}  // namespace mm_user

namespace {{
constexpr int kDim = {dim};
constexpr int kFlags = {flags};
using Inst = {instance_type(dim, flags)};
}}  // namespace
"""


def library_sources(source: str, dim: int, flags: int) -> dict:
    """The generated translation units of a per-density library, by
    name: one for each kernel, Kernel 1's with the probe."""
    return {name: _density_unit(source, dim, flags, header) + entry
            for name, (header, entry) in _ENTRIES.items()}


def library_path(source: str, dim: int, flags: int) -> Path:
    """Where :func:`lib_for` puts the library: its name hashes the
    source, D, the bits, nvcc's flags and every header."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(f"{dim}:{flags}\n".encode())
    h.update(source.encode())
    for p in sorted(_build.CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _build.BUILD_DIR / f"libmm_user_{h.hexdigest()[:16]}.so"


def jobs(requests) -> list:
    """The compile jobs (``_build.compile_libraries``) of the libraries of
    ``requests``, ``(source, dim, flags)`` triples, that are not built
    yet, their translation units written to ``GEN_DIR``."""
    out = []
    for source, dim, flags in requests:
        if not 1 <= dim <= MAX_DIM:
            raise ValueError(f"user densities run in Kernels 1-4 at D <= "
                             f"{MAX_DIM}; got D={dim}")
        so = library_path(source, dim, flags)
        if so.exists() or any(so == j[1] for j in out):
            continue
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        srcs = []
        for name, text in library_sources(source, dim, flags).items():
            path = GEN_DIR / f"{so.stem}_{name}.cu"
            path.write_text(text)
            srcs.append(path)
        out.append((srcs, so))
    return out


def build(requests) -> list:
    """Compile the libraries of ``requests``, ``(source, dim, flags)``
    triples, that are not built yet: every translation unit of every one
    in its own ``nvcc`` process, all started together. Returns their
    paths; raises ``RuntimeError`` with nvcc's output for a source that
    does not compile. The ``ptxas -v`` reports go to a ``.log`` beside
    each library, the seconds of its build to its first line."""
    _build.compile_libraries(jobs(requests))
    return [library_path(*r) for r in requests]


@functools.lru_cache(maxsize=64)
def _load(path: str) -> ctypes.CDLL:
    handle = _build.bind(ctypes.CDLL(path))
    handle.mm_user_probe.argtypes = [_P, _I, _P, _P, _P, _P]
    handle.mm_user_probe.restype = _I
    return handle


def lib_for(source: str, dim: int, flags: int) -> ctypes.CDLL:
    """The loaded library of ``source`` at ``dim`` under ``flags``, built
    first if need be (cached per process)."""
    (path,) = build([(source, dim, flags)])
    return _load(str(path))


@functools.lru_cache(maxsize=64)
def _resolved(target, dim: int, device: torch.device):
    forms = dc_forms(target, dim, device)
    handle = lib_for(forms.source, dim, _build.instance_flags(target))
    params = torch.tensor(forms.params or (0.0,), dtype=torch.float32,
                          device=device)
    return handle, params


def kernel_lib(target, dim: int, device) -> tuple:
    """``(library, target id, params pointer)`` of a user target's
    instance for Kernels 1-4 (the id is unused: a library holds one)."""
    handle, params = _resolved(target, dim, torch.device(device))
    return handle, 0, params.data_ptr()


def probe(target, x: torch.Tensor):
    """The compiled instance's ``(logp [R], grad [R, D])`` at the rows of
    ``x``, ``[R, D]`` float32: on the card through the per-density
    library's ``mm_user_probe`` (building it if need be), on the CPU
    through the host build (:func:`host_probe_lib`)."""
    x = x.detach().to(torch.float32).contiguous()
    r, d = x.shape
    logp = torch.empty((r,), dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x)
    if x.is_cuda:
        handle, params = _resolved(target, d, x.device)
        _build.check(handle.mm_user_probe(
            x.data_ptr(), r, params.data_ptr(), logp.data_ptr(),
            grad.data_ptr(), _build.stream_ptr(x.device)), handle)
        return logp, grad
    forms = dc_forms(target, d, "cpu")
    handle = host_probe_lib(forms.source, d, _build.instance_flags(target))
    params = np.asarray(forms.params or (0.0,), np.float32)
    handle.mm_user_probe_host(
        x.data_ptr(), r, params.ctypes.data, logp.data_ptr(),
        grad.data_ptr())
    return logp, grad


# --------------------------------------------------------------------------
# The host build, for the CPU tests


_HOST_UNIT = """// generated by mini_mcmc_torch/ops/kernels/user_density.py (host)
#include "host_shim.h"
#include "user_density.cuh"
#include "targets.cuh"

namespace mm_user {{
#line 1 "cuda_source"
{source}
}}  // namespace mm_user

using Inst = {inst};

extern "C" void mm_user_probe_host(const float* x, int rows,
                                   const float* params, float* logp,
                                   float* grad) {{
  const Inst t(params);
  for (int r = 0; r < rows; ++r) {{
    logp[r] = mm::probe_row<Inst, {dim}>(t, x + (long long)r * {dim},
                                         grad + (long long)r * {dim});
  }}
}}
"""
#: g++ flags of the host build: IEEE float arithmetic, as nvcc's without
#: -use_fast_math, and no contraction into FMAs beyond what the card does
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def host_probe_lib(source: str, dim: int, flags: int = 0) -> ctypes.CDLL:
    """``source`` at ``dim`` under ``flags`` built for the host with
    ``g++`` and ``csrc/host_shim.h``: ``mm_user_probe_host(x, rows,
    params, logp, grad)`` evaluates the instance on host arrays. The CPU
    tests alone use it; a compile error raises with g++'s output."""
    text = _HOST_UNIT.format(source=source, dim=dim,
                             inst=instance_type(dim, flags))
    return _host_load(text)


@functools.lru_cache(maxsize=64)
def _host_load(text: str) -> ctypes.CDLL:
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
    handle.mm_user_probe_host.argtypes = [_P, _I, _P, _P, _P]
    handle.mm_user_probe_host.restype = None
    return handle
