"""Kernel 4: a whole NUTS step per launch (``csrc/nuts_full.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/nuts_full.py:make_pallas_nuts_step``:
``(pos [C, D], eps [C], depth_limit, key, step) -> (new_pos [C, D], alpha,
n_alpha, diverged, depth [C] float32)``. Momentum, the slice, the doubling
loop with its directions, subtrees (the leaf and merge rule shared with
Kernel 3) and progressive accepts, and the outer U-turn run inside the
kernel; dual averaging stays in PyTorch (``ops/nuts.py:_finish_step``).

Draws come from Philox at ``(chain0 + chain, step, draw, sub-draw)`` under
the run's 64-bit key, one evaluation per four words the step uses plus at
most one per doubling (``csrc/philox.cuh``, Kernel 4): draw 0 gives the
momentum (words x, y: the cosine and sine of one Box-Muller pair) and the
slice's Exp(1) uniform (word z) at D <= 2; at D > 2 draws ``0..Q-1`` give
the momenta four to an evaluation (``Q = ceil(D / 4)``) and draw ``Q``'s
word x the slice. Draw ``0x10000 + j`` gives doubling ``j``: sub-draw 0
its direction coin (word x) and progressive-accept uniform (word y),
sub-draw ``1 + q`` its merge uniforms of ordinals ``4q..4q+3``, the merge
at leaf ``i``, cascade position ``k`` having ordinal ``i - popcount(i) +
k``. So :func:`nuts_step_plain` reproduces the kernel's draws exactly and a
step's result depends on (key, step, chain) alone: not on the grid, the
lane that runs a chain, the batch split or the depth cap beyond the depth
reached.

``depth`` is each chain's own doubling count, and ``2^depth - 1`` the
leapfrogs its own tree takes, which the sampler's ``leapfrogs`` counter
records. The kernel runs a persistent grid whose warps take 32 chains at a
time from a device counter (one per device and stream, :func:`_counter`)
and run them in lockstep, so the card integrates each warp's deepest tree
for all 32 (the load balance, ``stats`` below).

:func:`nuts_step` launches the CUDA kernel for CUDA tensors and runs
:func:`nuts_step_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ...parallel.collectives import any_chains, split, state_sum
from . import _build, rng
from .hmc import check_state
from .nuts_subtree import MAX_DEPTH, build_subtree_plain, popcount

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('NUTS use_pallas="full" (Kernel 4)', torch.float32)

#: Philox draw index of doubling j (its coin, accept and merge uniforms) is
#: DOUBLING_DRAW + j
DOUBLING_DRAW = 0x10000


def doubling_loop(positions, mom_0, grad, joint, depth_limit: int,
                  draw_direction: Callable, draw_accept: Callable,
                  subtree: Callable, chains=None, state=None):
    """The NUTS doubling loop for all chains in lockstep
    (``mini_mcmc_tpu/ops/nuts.py:_nuts_step_batched``, reference
    ``nuts.rs:578-674``), shared by every tier's plain path.

    ``draw_direction(j)`` and ``draw_accept(j)`` give doubling ``j``'s
    ``[C]`` uniforms; ``subtree(j, pos, mom, grad, v, active)`` builds its
    subtree (a ``TreeResult``). Runs while ``j < depth_limit`` and any chain
    continues. Returns ``(position_sel, alpha, n_alpha, diverged, depth)``
    with ``depth [C]`` int32 the doublings each chain took part in. Under
    ``chains`` (a sharded lockstep run's ChainGroup) it runs while a chain
    of any shard continues, so every rank builds the same subtrees and
    their leaf loops' reductions pair up. Under ``state`` (a split D's
    ``StateGroup``) the U-turn products between the ends cross the axis,
    one all-reduce a doubling.
    """
    dtype = positions.dtype
    c = positions.shape[0]
    dev = positions.device
    pos_m = pos_p = positions
    mom_m = mom_p = mom_0
    grad_m = grad_p = grad
    position_sel = positions
    n = torch.ones((c,), dtype=torch.int32, device=dev)
    s = torch.ones((c,), dtype=torch.bool, device=dev)
    alpha = torch.zeros((c,), dtype=dtype, device=dev)
    n_alpha = torch.zeros((c,), dtype=torch.int32, device=dev)
    diverged = torch.zeros((c,), dtype=torch.bool, device=dev)
    depth = torch.zeros((c,), dtype=torch.int32, device=dev)
    j = 0
    while j < depth_limit and any_chains(s, chains):
        v = torch.where(draw_direction(j) < 0.5, -1, 1).to(torch.int32)
        neg = (v == -1)[:, None]
        res = subtree(j, torch.where(neg, pos_m, pos_p),
                      torch.where(neg, mom_m, mom_p),
                      torch.where(neg, grad_m, grad_p), v, s)
        upd_m = neg & s[:, None]
        upd_p = ~neg & s[:, None]
        pos_m = torch.where(upd_m, res.end_pos, pos_m)
        mom_m = torch.where(upd_m, res.end_mom, mom_m)
        grad_m = torch.where(upd_m, res.end_grad, grad_m)
        pos_p = torch.where(upd_p, res.end_pos, pos_p)
        mom_p = torch.where(upd_p, res.end_mom, mom_p)
        grad_p = torch.where(upd_p, res.end_grad, grad_p)

        # progressive acceptance: u < min(1, n'/n) (nuts.rs:656-663)
        ratio = res.n.to(dtype) / n.to(dtype)
        take = s & res.s & (draw_accept(j) < torch.clamp(ratio, max=1.0))
        position_sel = torch.where(take[:, None], res.prop_pos, position_sel)

        n = n + torch.where(s, res.n, 0)
        d = pos_p - pos_m
        dot_m, dot_p = torch.sum(d * mom_m, dim=1), torch.sum(d * mom_p, dim=1)
        if split(state):
            dot_m, dot_p = state_sum(torch.stack([dot_m, dot_p]), state)
        no_uturn = (dot_m >= 0) & (dot_p >= 0)
        alpha = torch.where(s, res.alpha, alpha)
        n_alpha = torch.where(s, res.n_alpha, n_alpha)
        diverged = diverged | (s & res.diverged)
        depth = depth + s.to(torch.int32)
        s = s & res.s & no_uturn
        j += 1
    return position_sel, alpha, n_alpha, diverged, depth


def momentum_and_slice(chain: torch.Tensor, step: int, dim: int, seed: int):
    """The step's ``[C, D]`` momentum and ``[C]`` slice uniform: draws
    ``0..Q-1`` (``Q = ceil(D / 4)``) give the momenta by paired Box-Muller,
    words x, y the cosine and sine of one pair and words z, w of the next;
    the slice is word z of draw 0 at D <= 2 (unused by the momenta), else
    word x of draw ``Q``."""
    key = rng.seed_words(seed)
    q = (dim + 3) // 4
    quad = torch.arange(q, device=chain.device)
    w = rng.philox4x32_10(chain[:, None], step, quad[None, :], 0, key)
    normals = (rng.box_muller_pair(w[0], w[1])
               + rng.box_muller_pair(w[2], w[3]))
    mom = torch.stack(normals, dim=2).reshape(chain.shape[0], -1)[:, :dim]
    if dim <= 2:
        bits = w[2][:, 0]
    else:
        bits = rng.philox4x32_10(chain, step, q, 0, key)[0]
    return mom, rng.unit_open(bits)


def doubling_uniforms(chain: torch.Tensor, step: int, j: int, seed: int):
    """Doubling ``j``'s ``[C]`` direction and progressive-accept uniforms:
    words x and y of draw ``DOUBLING_DRAW + j``, sub-draw 0."""
    w = rng.philox4x32_10(chain, step, DOUBLING_DRAW + j, 0,
                          rng.seed_words(seed))
    return rng.unit_open(w[0]), rng.unit_open(w[1])


def merge_ordinal(i: int, k: int) -> int:
    """The ordinal within its doubling of the merge at leaf ``i``, cascade
    position ``k``: the merges of leaves ``0..i-1`` number
    ``i - popcount(i)``, so a doubling's ``2^j - 1`` merges take ordinals
    ``0..2^j - 2``."""
    return i - popcount(i) + k


def merge_uniform(chain: torch.Tensor, step: int, j: int, i: int, k: int,
                  seed: int) -> torch.Tensor:
    """The ``[C]`` merge uniform at leaf ``i``, cascade position ``k`` of
    doubling ``j``: word ``o % 4`` of draw ``DOUBLING_DRAW + j``, sub-draw
    ``1 + o // 4``, for the ordinal ``o``."""
    o = merge_ordinal(i, k)
    w = rng.philox4x32_10(chain, step, DOUBLING_DRAW + j, 1 + o // 4,
                          rng.seed_words(seed))
    return rng.unit_open(w[o % 4])


def nuts_step_plain(target, pos, eps, depth_limit: int, seed: int,
                    step: int, max_depth: int, chain0: int = 0,
                    details: dict | None = None):
    """Plain PyTorch twin of the kernel: the same Philox draws, the
    doubling loop and the builder in lockstep. A ``details`` dict receives
    each chain's leaves integrated (``"leaves"``), the work of the kernel
    for that chain, and its doubling count (``"depth"``, int32)."""
    nuts_step_plain.calls += 1
    c, dim = pos.shape
    chain = torch.arange(chain0, chain0 + c, device=pos.device)
    step &= 0xFFFFFFFF
    mom, u_slice = momentum_and_slice(chain, step, dim, seed)
    mom_0 = mom.to(pos.dtype)
    logp, grad = target.batch_logp_and_grad(pos)
    joint = logp - 0.5 * torch.sum(mom_0 * mom_0, dim=1)
    # logu = joint - Exp(1), Exp(1) = -ln U (nuts.rs:563-564)
    logu = joint + torch.log(u_slice).to(pos.dtype)

    coins = {}

    def doubling(j):
        if j not in coins:
            coins[j] = tuple(u.to(pos.dtype) for u in
                             doubling_uniforms(chain, step, j, seed))
        return coins[j]

    leaves = torch.zeros((c,), dtype=torch.int32, device=pos.device)

    def subtree(j, p, m, g, v, active):
        done = torch.zeros_like(leaves)
        res = build_subtree_plain(
            target, max_depth, p, m, g, logu, v, j, eps, joint, active,
            lambda i, k: merge_uniform(chain, step, j, i, k, seed).to(
                pos.dtype), done)
        leaves.add_(torch.where(active, done, 0))
        return res

    sel, alpha, n_alpha, diverged, depth = doubling_loop(
        pos, mom_0, grad, joint, depth_limit, lambda j: doubling(j)[0],
        lambda j: doubling(j)[1], subtree)
    if details is not None:
        details.update(depth=depth, leaves=leaves)
    return (sel, alpha, n_alpha.to(torch.float32),
            diverged.to(torch.float32), depth.to(torch.float32))


nuts_step_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's chain counter for launches on ``stream`` of ``device``:
    two zeroed words that every launch leaves zeroed (its last block resets
    them). One per stream, so launches in flight on two streams never take
    each other's chains; it is zeroed on ``stream`` itself, the current
    stream when first asked for."""
    return torch.zeros((2,), dtype=torch.int32, device=device)


def nuts_step(target, pos, eps, depth_limit: int, seed: int, step: int,
              max_depth: int, chain0: int = 0, *, blocks: int = 0,
              stats: torch.Tensor | None = None, grid: dict | None = None):
    """One NUTS step of ``target`` for every chain from ``pos [C, D]`` at
    step sizes ``eps [C]``; ``seed`` is the run's 64-bit Philox key and
    ``step`` the global step index. Returns ``(new_pos, alpha, n_alpha,
    diverged, depth)``, the last four ``[C]`` float32.

    On the card, none of these changes a result: ``blocks`` sets the grid
    (0: the resident blocks); ``stats``, a zeroed int64 ``[2]`` tensor on
    the device, receives the launch's lane-iterations and leaves; ``grid``,
    a dict, receives ``blocks_per_sm``, ``sms`` and the ``blocks`` and
    ``threads`` a block launched.
    """
    if pos.dtype != torch.float32:
        raise ValueError(
            "the fused NUTS step is float32-only; got positions of dtype "
            f"{pos.dtype}. Use use_pallas=False or True for other dtypes.")
    if not pos.is_cuda:
        return nuts_step_plain(target, pos, eps, depth_limit, seed, step,
                               max_depth, chain0)
    if max_depth > MAX_DEPTH or not 0 <= depth_limit <= max_depth:
        raise ValueError(
            f"the NUTS step kernel is built for max_depth <= {MAX_DEPTH} "
            f"and 0 <= depth_limit <= max_depth; got max_depth={max_depth},"
            f" depth_limit={depth_limit}")
    check_state(pos, eps, dims=_build.kernel_dims(target),
                tier=TIER)
    lib, tid, params = _build.kernel_lib(target, pos.shape[1], pos.device)
    c, d = pos.shape
    if eps.shape != (c,):
        raise ValueError(f"eps must be [C] = [{c}]; got {tuple(eps.shape)}")
    if stats is not None and (stats.shape != (2,) or stats.dtype
                              != torch.int64 or stats.device != pos.device):
        raise ValueError("stats must be an int64 [2] tensor on the device")
    new_pos = torch.empty_like(pos)
    alpha, n_alpha, diverged, depth = (
        torch.empty((c,), dtype=torch.float32, device=pos.device)
        for _ in range(4))
    launched = (ctypes.c_int * 4)()
    k0, k1 = rng.seed_words(seed)
    stream = _build.stream_ptr(pos.device)
    nuts_step.launches += 1
    nuts_step.transformed_launches += (
        target.cuda_transform is not None)
    nuts_step.user_launches += target.cuda_functor is None
    _build.check(lib.mm_nuts_step_f32(
        pos.data_ptr(), eps.data_ptr(), params, depth_limit, max_depth, k0,
        k1, step & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, c, d, tid,
        _build.instance_flags(target),
        _counter(pos.device, stream).data_ptr(), blocks,
        None if stats is None else stats.data_ptr(), new_pos.data_ptr(),
        alpha.data_ptr(), n_alpha.data_ptr(), diverged.data_ptr(),
        depth.data_ptr(), pos.device.index, ctypes.addressof(launched),
        stream,
    ), lib)
    if grid is not None:
        grid.update(zip(("blocks_per_sm", "sms", "blocks", "threads"),
                        launched))
    return new_pos, alpha, n_alpha, diverged, depth


nuts_step.launches = 0
#: the launches of the transformed instances (``mm::Transformed``, a
#: metric's wrapper around it included), also counted in ``launches``
nuts_step.transformed_launches = 0
#: the launches of user instances (``user_density.py``), also counted in
#: ``launches``
nuts_step.user_launches = 0
