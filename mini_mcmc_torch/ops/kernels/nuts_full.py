"""Kernel 4: a whole NUTS step per launch (``csrc/nuts_full.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/nuts_full.py:make_pallas_nuts_step``:
``(pos [C, D], eps [C], depth_limit, key, step) -> (new_pos [C, D], alpha,
n_alpha, diverged, depth [C] float32)``. Momentum, the slice, the doubling
loop with its directions, subtrees (the builder shared with Kernel 3) and
progressive accepts, and the outer U-turn run inside the kernel; dual
averaging stays in PyTorch (``ops/nuts.py:_finish_step``).

Draws come from Philox at ``(chain0 + chain, step, draw, sub-draw)`` under
the run's 64-bit key (layout in ``rng.py``), so :func:`nuts_step_plain`
reproduces the kernel's draws exactly and a step's result depends on
(key, step, chain) alone: not on the grid, the batch split or the depth
cap beyond the depth reached.

``depth`` is the deepest doubling count of each chain's warp of 32 chains
(chains ``32w .. 32w + 31`` of the launch): a warp runs in lockstep, so
``2^depth - 1`` leapfrogs is the per-warp cost the sampler's ``leapfrogs``
counter records.

:func:`nuts_step` launches the CUDA kernel for CUDA tensors and runs
:func:`nuts_step_plain` for CPU tensors only.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import _build, rng
from .hmc import check_state
from .nuts_subtree import MAX_DEPTH, build_subtree_plain

#: Philox draw index of doubling j's merge uniforms is MERGE_DRAW + j
MERGE_DRAW = 0x10000
#: the lockstep unit of the card, over which ``depth`` is reported
WARP = 32


def doubling_loop(positions, mom_0, grad, joint, depth_limit: int,
                  draw_direction: Callable, draw_accept: Callable,
                  subtree: Callable):
    """The NUTS doubling loop for all chains in lockstep
    (``mini_mcmc_tpu/ops/nuts.py:_nuts_step_batched``, reference
    ``nuts.rs:578-674``), shared by every tier's plain path.

    ``draw_direction(j)`` and ``draw_accept(j)`` give doubling ``j``'s
    ``[C]`` uniforms; ``subtree(j, pos, mom, grad, v, active)`` builds its
    subtree (a ``TreeResult``). Runs while ``j < depth_limit`` and any chain
    continues. Returns ``(position_sel, alpha, n_alpha, diverged, depth)``
    with ``depth [C]`` int32 the doublings each chain took part in.
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
    while j < depth_limit and bool(s.any()):
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
        no_uturn = ((torch.sum(d * mom_m, dim=1) >= 0)
                    & (torch.sum(d * mom_p, dim=1) >= 0))
        alpha = torch.where(s, res.alpha, alpha)
        n_alpha = torch.where(s, res.n_alpha, n_alpha)
        diverged = diverged | (s & res.diverged)
        depth = depth + s.to(torch.int32)
        s = s & res.s & no_uturn
        j += 1
    return position_sel, alpha, n_alpha, diverged, depth


def warp_max(x: torch.Tensor) -> torch.Tensor:
    """Each entry replaced by the largest of its warp of 32 (the last warp
    may be short)."""
    c = x.shape[0]
    pad = (-c) % WARP
    padded = torch.cat([x, x.new_zeros((pad,))]) if pad else x
    m = padded.reshape(-1, WARP).amax(dim=1)
    return m.repeat_interleave(WARP)[:c]


def nuts_step_plain(target, pos, eps, depth_limit: int, seed: int,
                    step: int, max_depth: int, chain0: int = 0,
                    details: dict | None = None):
    """Plain PyTorch twin of the kernel: the same Philox draws, the
    doubling loop and the builder in lockstep. A ``details`` dict receives
    each chain's own doubling count (``"depth"``) and the leaves it
    integrated (``"leaves"``), the work of one kernel thread."""
    nuts_step_plain.calls += 1
    c, dim = pos.shape
    chain = torch.arange(chain0, chain0 + c, device=pos.device)
    step &= 0xFFFFFFFF
    events = max_depth + 1
    draw = torch.arange(dim, device=pos.device)
    key = rng.seed_words(seed)
    w0, w1, _, _ = rng.philox4x32_10(chain[:, None], step, draw[None, :], 0,
                                     key)
    mom_0 = rng.box_muller(w0, w1).to(pos.dtype)
    logp, grad = target.batch_logp_and_grad(pos)
    joint = logp - 0.5 * torch.sum(mom_0 * mom_0, dim=1)
    # logu = joint - Exp(1), Exp(1) = -ln U (nuts.rs:563-564)
    logu = joint + torch.log(rng.uniform_at(chain, step, dim, seed)).to(
        pos.dtype)

    def uniform(draw_index, sub=0):
        return rng.uniform_at(chain, step, draw_index, seed, sub).to(
            pos.dtype)

    leaves = torch.zeros((c,), dtype=torch.int32, device=pos.device)

    def subtree(j, p, m, g, v, active):
        done = torch.zeros_like(leaves)
        res = build_subtree_plain(
            target, max_depth, p, m, g, logu, v, j, eps, joint, active,
            lambda i, k: uniform(MERGE_DRAW + j, i * events + k), done)
        leaves.add_(torch.where(active, done, 0))
        return res

    sel, alpha, n_alpha, diverged, depth = doubling_loop(
        pos, mom_0, grad, joint, depth_limit,
        lambda j: uniform(dim + 1 + 2 * j), lambda j: uniform(dim + 2 + 2 * j),
        subtree)
    if details is not None:
        details.update(depth=depth, leaves=leaves)
    return (sel, alpha, n_alpha.to(torch.float32),
            diverged.to(torch.float32), warp_max(depth).to(torch.float32))


nuts_step_plain.calls = 0


def nuts_step(target, pos, eps, depth_limit: int, seed: int, step: int,
              max_depth: int, chain0: int = 0):
    """One NUTS step of ``target`` for every chain from ``pos [C, D]`` at
    step sizes ``eps [C]``; ``seed`` is the run's 64-bit Philox key and
    ``step`` the global step index. Returns ``(new_pos, alpha, n_alpha,
    diverged, depth)``, the last four ``[C]`` float32."""
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
    tid = _build.functor_id(target)
    check_state(pos, eps)
    c, d = pos.shape
    if eps.shape != (c,):
        raise ValueError(f"eps must be [C] = [{c}]; got {tuple(eps.shape)}")
    new_pos = torch.empty_like(pos)
    alpha, n_alpha, diverged, depth = (
        torch.empty((c,), dtype=torch.float32, device=pos.device)
        for _ in range(4))
    k0, k1 = rng.seed_words(seed)
    lib = _build.lib()
    nuts_step.launches += 1
    _build.check(lib.mm_nuts_step_f32(
        pos.data_ptr(), eps.data_ptr(), _build.params_ptr(target, pos.device),
        depth_limit, max_depth, k0, k1, step & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
        c, d, tid, new_pos.data_ptr(), alpha.data_ptr(), n_alpha.data_ptr(),
        diverged.data_ptr(), depth.data_ptr(), _build.stream_ptr(pos.device),
    ))
    return new_pos, alpha, n_alpha, diverged, depth


nuts_step.launches = 0
