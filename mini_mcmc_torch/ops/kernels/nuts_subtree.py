"""Kernel 3: one 2^j-leaf NUTS subtree (``csrc/nuts_subtree.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/nuts_subtree.py:make_pallas_subtree``
with its contract (the ``_TreeResult`` of ``ops/nuts.py``). This module also
holds :func:`build_subtree_plain`, the single plain copy of the tree math
(binary-counter leaves, stack pushes, merge cascade with progressive swap,
inner U-turn, divergence, NaN laundering), with the merge uniform injected
as ``draw_uniform(i, k)``: the ``use_pallas=False`` tier passes the step's
``torch.Generator``, the Kernel 3 twin the counter hash below, the Kernel 4
twin (``nuts_full.py``) Philox.

The hash is the TPU kernel's own (``_mix32``/``_hash_u24``/``_hash_unit``)
over ``(seed0, seed1, i * (max_depth + 1) + k, chain0 + c)`` (the
chain's global index, ``chain0`` a shard's offset), in int32
semantics (wrapping multiplies, arithmetic shifts) computed on int64
tensors, so the twin reproduces the JAX kernel run in interpret mode.

:func:`subtree` launches the CUDA kernel for CUDA tensors and runs
:func:`subtree_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ...parallel.collectives import any_chains
from . import _build
from .hmc import check_state

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier("NUTS use_pallas=True (Kernel 3)", torch.float32)

#: csrc/nuts_tree.cuh kMaxDepth: the kernels take max_depth up to this
MAX_DEPTH = 10
#: divergence threshold: s' = (logu - 1000) < joint (nuts.rs:807)
DIVERGENCE_DELTA = 1000.0

_MASK = 0xFFFFFFFF


class TreeResult(NamedTuple):
    """A batched subtree (``ops/nuts.py:_TreeResult``)."""

    end_pos: torch.Tensor  # [C, D] chronological last integration state
    end_mom: torch.Tensor  # [C, D]
    end_grad: torch.Tensor  # [C, D]
    prop_pos: torch.Tensor  # [C, D] selected proposal
    prop_grad: torch.Tensor  # [C, D]
    prop_logp: torch.Tensor  # [C]
    n: torch.Tensor  # [C] int32 slice-passing count
    s: torch.Tensor  # [C] bool: no divergence and no sub-U-turn
    alpha: torch.Tensor  # [C]
    n_alpha: torch.Tensor  # [C] int32
    diverged: torch.Tensor  # [C] bool


def popcount(i: int) -> int:
    return bin(i).count("1")


def trailing_ones(i: int) -> int:
    """Number of trailing 1-bits of ``i`` (= ctz(i + 1)): the merges after
    leaf ``i``."""
    x = i + 1
    return (x & -x).bit_length() - 1


def build_subtree_plain(target, max_depth: int, pos, mom, grad, logu, v,
                        j: int, epsilon, joint_0, active,
                        draw_uniform: Callable, leaves=None, *,
                        chains=None, state=None) -> TreeResult:
    """Grow the 2^j-leaf subtree for all chains in lockstep
    (``mini_mcmc_tpu/ops/nuts.py:_build_subtree_batched``, reference
    ``nuts.rs:763-946``).

    ``v`` is the ``[C]`` int direction, ``epsilon``/``logu``/``joint_0``
    ``[C]``, ``active`` the ``[C]`` bool mask of chains whose accumulators
    may change. Leaves run while any chain's own ``s`` holds: a stopped
    chain's n, s, alpha, n_alpha and divergence flag stay fixed, and its
    end state and proposal are not used by the caller. ``leaves``, an
    optional ``[C]`` int tensor, is incremented in place by the leaves each
    chain integrates before it stops (the work of a kernel thread).
    Under ``chains`` (a sharded run's
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`) the leaf
    loop runs while a chain of any shard runs, one scalar reduction a leaf.
    Under ``state`` (a split D's
    :class:`~mini_mcmc_torch.parallel.collectives.StateGroup`) ``pos``,
    ``mom`` and ``grad`` are the rank's D-slices: a leaf's logp share,
    kinetic energy and the two U-turn dot products of every merge after
    it cross the axis in one all-reduce (``ops/nuts.py:summed``), so every
    shard of a chain holds the same ``s``.
    """
    from ..nuts import logp_and_grad, summed

    dtype = pos.dtype
    c, dim = pos.shape
    # stack row: [first_pos | first_mom | prop_pos | prop_grad | prop_logp | n]
    fp, fm = slice(0, dim), slice(dim, 2 * dim)
    pp, pg = slice(2 * dim, 3 * dim), slice(3 * dim, 4 * dim)
    i_lp, i_n = 4 * dim, 4 * dim + 1
    stack = torch.zeros((max_depth + 1, c, 4 * dim + 2), dtype=dtype,
                        device=pos.device)
    vf = v.to(dtype)
    eps_signed = epsilon * vf
    half = (eps_signed * 0.5)[:, None]
    e = eps_signed[:, None]
    s_run = torch.ones((c,), dtype=torch.bool, device=pos.device)
    n_tot = torch.zeros((c,), dtype=torch.int32, device=pos.device)
    alpha_tot = torch.zeros((c,), dtype=dtype, device=pos.device)
    n_alpha_tot = torch.zeros((c,), dtype=torch.int32, device=pos.device)
    diverged = torch.zeros((c,), dtype=torch.bool, device=pos.device)

    for i in range(1 << j):
        if i and not any_chains(s_run, chains):
            break
        if leaves is not None:
            leaves += s_run
        # leaf: one leapfrog for every chain (nuts.rs:795-830)
        mom = mom + grad * half
        pos = pos + mom * e
        logp, grad = logp_and_grad(target, pos, state)
        mom = mom + grad * half
        sp = popcount(i)
        # the U-turn products of the merges after this leaf: the leaf
        # against the stack rows the carries meet (each read before the
        # cascade writes over it)
        dots = []
        for k in range(trailing_ones(i)):
            a = stack[sp - 1 - k]
            d_chrono = pos - a[:, fp]
            dots += [torch.sum(d_chrono * a[:, fm], dim=1),
                     torch.sum(d_chrono * mom, dim=1)]
        logp, ke, *dots = summed(state, logp, torch.sum(mom * mom, dim=1),
                                 *dots)
        joint = logp - 0.5 * ke
        n_leaf = logu < joint
        s_leaf = (logu - DIVERGENCE_DELTA) < joint
        alpha_leaf = torch.clamp(torch.exp(joint - joint_0), max=1.0)
        # a NaN energy (inf kinetic energy on a wild excursion) is already
        # a divergence; as 0 acceptance it cannot poison dual averaging
        alpha_leaf = torch.where(torch.isnan(alpha_leaf), 0.0, alpha_leaf)

        live = active & s_run
        n_tot = n_tot + (live & n_leaf).to(torch.int32)
        alpha_tot = alpha_tot + torch.where(live, alpha_leaf, 0.0)
        n_alpha_tot = n_alpha_tot + live.to(torch.int32)
        diverged = diverged | (live & ~s_leaf)
        s_run = s_run & s_leaf

        top = torch.cat([pos, mom, pos, grad, logp[:, None],
                         n_leaf.to(dtype)[:, None]], dim=1)
        stack[sp] = top
        # merge cascade: the binary counter's carries (nuts.rs:858-929)
        for k in range(trailing_ones(i)):
            ia = sp - 1 - k
            a = stack[ia]
            n_a, n_b = a[:, i_n], top[:, i_n]
            u = draw_uniform(i, k)
            take_b = (u < n_b / torch.clamp(n_a + n_b, min=1.0))[:, None]
            ok = (vf * dots[2 * k] >= 0) & (vf * dots[2 * k + 1] >= 0)
            top = torch.cat([
                a[:, fp], a[:, fm],
                torch.where(take_b, top[:, pp], a[:, pp]),
                torch.where(take_b, top[:, pg], a[:, pg]),
                torch.where(take_b, top[:, i_lp:i_lp + 1], a[:, i_lp:i_lp + 1]),
                (n_a + n_b)[:, None],
            ], dim=1)
            stack[ia] = top
            s_run = s_run & ok

    root = stack[0]
    return TreeResult(pos, mom, grad, root[:, pp], root[:, pg], root[:, i_lp],
                      n_tot, s_run, alpha_tot, n_alpha_tot, diverged)


def _sar(x, k: int):
    """Arithmetic right shift of int32 words held as [0, 2**32) in int64."""
    return ((x - ((x >> 31) << 32)) >> k) & _MASK


def _mul32(x, m: int):
    """Low 32 bits of ``x * m`` (a wrapping int32 multiply) for
    ``x, m < 2**32``, without overflowing int64."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _MASK


def _mix32(x):
    """``nuts_subtree.py:_mix32``: the murmur3 finalizer."""
    x = x ^ _sar(x, 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ _sar(x, 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ _sar(x, 16)


def hash_u24(seed0, seed1, event, lane):
    """``nuts_subtree.py:_hash_u24``: 24 hashed bits of (seed0, seed1,
    event, lane), int32 words (tensors or ints, any sign) in, int64 out."""
    x = ((seed0 & _MASK) + _mul32(event & _MASK, 0x9E3779B9)) & _MASK
    x = _mix32((lane & _MASK) ^ x)
    x = _mix32(x ^ (seed1 & _MASK))
    return (x & 0x7FFFFFFF) >> 7


def hash_unit(seed0, seed1, event, lane) -> torch.Tensor:
    """``nuts_subtree.py:_hash_unit``: the hash as a float32 in (0, 1)."""
    u24 = hash_u24(seed0, seed1, event, lane)
    return u24.to(torch.float32) * (1.0 / 16777216.0) + (1.0 / 33554432.0)


def subtree_plain(target, pos, mom, grad, logu, v, j: int, eps, joint0,
                  active, seed, max_depth: int, leaves=None, *,
                  chain0: int = 0, chains=None) -> TreeResult:
    """Plain PyTorch twin of the kernel: :func:`build_subtree_plain` with
    the hash's merge uniforms, lane = ``chain0`` + chain index (``leaves``
    and ``chains`` as there)."""
    subtree_plain.calls += 1
    lane = torch.arange(chain0, chain0 + pos.shape[0], device=pos.device)
    seed0, seed1 = seed
    events = max_depth + 1
    return build_subtree_plain(
        target, max_depth, pos, mom, grad, logu, v, j, eps, joint0, active,
        lambda i, k: hash_unit(seed0, seed1, i * events + k, lane).to(
            pos.dtype), leaves, chains=chains)


subtree_plain.calls = 0


def subtree(target, pos, mom, grad, logu, v, j: int, eps, joint0, active,
            seed, max_depth: int, *, grid: dict | None = None,
            chain0: int = 0, chains=None) -> TreeResult:
    """The 2^j-leaf subtree of ``target`` from ``(pos, mom, grad)`` in
    direction ``v`` (``[C]`` int, +-1) at step ``eps [C]``; ``seed`` is the
    hash's two int32 words, ``chain0`` the global index of the first chain
    (the hash's lane is the chain's global index). Returns a
    :class:`TreeResult`. ``chains`` (a sharded run's
    :class:`~mini_mcmc_torch.parallel.collectives.ChainGroup`) reaches the
    twin's leaf loop only: its exit tests every shard's chains.

    On the card ``grid``, a dict, receives ``blocks_per_sm`` (the blocks an
    SM holds at this ``j``), ``sms`` and the ``blocks`` launched; it
    changes no result."""
    if not pos.is_cuda:
        return subtree_plain(target, pos, mom, grad, logu, v, j, eps, joint0,
                             active, seed, max_depth, chain0=chain0,
                             chains=chains)
    if max_depth > MAX_DEPTH or not 0 <= j <= max_depth:
        raise ValueError(
            f"the subtree kernel is built for max_depth <= {MAX_DEPTH} and "
            f"0 <= j <= max_depth; got max_depth={max_depth}, j={j}")
    v = v.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    check_state(pos, mom, grad, logu, eps, joint0,
                dims=_build.kernel_dims(target),
                tier=TIER)
    lib, tid, params = _build.kernel_lib(target, pos.shape[1], pos.device)
    c, d = pos.shape
    if (mom.shape != pos.shape or grad.shape != pos.shape
            or any(x.shape != (c,) for x in (logu, v, eps, joint0, active))
            or v.device != pos.device or active.device != pos.device):
        raise ValueError("expected pos/mom/grad [C, D] and logu, v, eps, "
                         "joint0, active [C] on one device")
    f32 = dict(dtype=torch.float32, device=pos.device)
    end_pos, end_mom, end_grad, prop_pos, prop_grad = (
        torch.empty_like(pos) for _ in range(5))
    prop_logp = torch.empty((c,), **f32)
    alpha = torch.empty((c,), **f32)
    n = torch.empty((c,), dtype=torch.int32, device=pos.device)
    n_alpha = torch.empty_like(n)
    s = torch.empty((c,), dtype=torch.bool, device=pos.device)
    diverged = torch.empty_like(s)
    seed0, seed1 = (int(w) & _MASK for w in seed)
    seed0, seed1 = (w - (1 << 32) if w >> 31 else w for w in (seed0, seed1))
    launched = (ctypes.c_int * 3)()
    subtree.launches += 1
    subtree.transformed_launches += (
        target.cuda_transform is not None)
    subtree.user_launches += target.cuda_functor is None
    _build.check(lib.mm_nuts_subtree_f32(
        pos.data_ptr(), mom.data_ptr(), grad.data_ptr(), logu.data_ptr(),
        v.data_ptr(), eps.data_ptr(), joint0.data_ptr(), active.data_ptr(),
        params, j, max_depth, seed0, seed1, chain0 & _MASK, c, d, tid,
        _build.instance_flags(target), end_pos.data_ptr(),
        end_mom.data_ptr(), end_grad.data_ptr(),
        prop_pos.data_ptr(), prop_grad.data_ptr(), prop_logp.data_ptr(),
        n.data_ptr(), s.data_ptr(), alpha.data_ptr(), n_alpha.data_ptr(),
        diverged.data_ptr(), pos.device.index,
        None if grid is None else ctypes.addressof(launched),
        _build.stream_ptr(pos.device),
    ), lib)
    if grid is not None:
        grid.update(zip(("blocks_per_sm", "sms", "blocks"), launched))
    return TreeResult(end_pos, end_mom, end_grad, prop_pos, prop_grad,
                      prop_logp, n, s, alpha, n_alpha, diverged)


subtree.launches = 0
#: the launches of the transformed instances (``mm::Transformed``, a
#: metric's wrapper around it included), also counted in ``launches``
subtree.transformed_launches = 0
#: the launches of user instances (``user_density.py``), also counted in
#: ``launches``
subtree.user_launches = 0
