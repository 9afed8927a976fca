"""Kernel 8: K fused parallel-tempering steps per launch
(``csrc/pt_multistep.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/tempering_full.py:make_pallas_pt_multistep``
(and its K = 1 form without history). Per step and chain: ``n_inner``
tempered random-walk sweeps over all T rungs at scale ``sigma_d /
sqrt(beta_t)``, then the alternating-parity neighbour swap and the swap
EWMA, with true selects throughout (a ``-inf`` log density stays
``-inf``). Only the cold rung goes into ``hist``, a ``[K, C, D]`` view of
the runner's cube (unit D stride), written in place.

A transformed target (``transform=``) runs the instances inside
``targets.cuh:Transformed``: the replicas walk the unconstrained y, each
rung's density ``beta_t`` times ``logp(g(y)) + log|g'(y)|``, the twin's
``target.batch_logp`` of the wrapped target; those launches are also
counted in ``pt_multistep.transformed_launches``.

State layout is the JAX package's: positions ``[T, D, C]``, raw logp
``[T, C]``, swap EWMA ``[T-1, C]``, all float32; the parity of the first
step is a host int and that of step k is ``(parity + k) % 2``. The draws are
Philox by place (``csrc/philox.cuh``, Kernel 8), one evaluation per (chain,
rung, step, sweep): counter ``(chain, step, t, i)`` gives rung t's sweep i,
words x and y its proposal normal (the cosine branch at D = 1, the cosine
and sine of one Box-Muller pair at D = 2), word z its accept uniform, and
at i = 0 word w the swap uniform of pair (t, t+1). Past D = 2 normals
2p and 2p + 1 are the cosine and sine of the pair on words x, y of draw
``p T + t`` (:func:`pt_draws`).

A user density (``Target.cuda_source``, or the C++ generated from its
batch form) runs at D = 1-16 in its value-only library
(``user_density.value_lib``), which holds Kernel 5's isotropic walk too.

What bounds it on the H100: operations. One thread per (chain, rung),
the rungs of a chain in adjacent lanes of one warp, so 8,192 chains at
T = 8 fill the card with 2,048 warps; each thread keeps its rung's
position, logp and pair EWMA in registers for all K steps and swaps by
warp shuffle. A step at T = 8, D = 1 is 8 Philox-10 evaluations, 8
Box-Muller transforms and 8 mixture densities per chain against 4 bytes
of history.

:func:`pt_multistep` launches the kernel for CUDA tensors and runs
:func:`pt_multistep_plain` for CPU tensors only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, rng, user_density

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('ParallelTempering use_pallas="full" (Kernel 8)',
                   torch.float32)

_MASK = 0xFFFFFFFF


class Ladder(NamedTuple):
    """The temperature ladder on a device, in float32."""

    beta: torch.Tensor  # [T]
    sigma_l: torch.Tensor  # [T, D or 1, 1]: sigma_d / sqrt(beta_t)
    #: the kernel's: beta [T], beta_t - beta_{t+1} [T-1], scales [T, D]
    packed: torch.Tensor


def make_ladder(betas, proposal_std, dim: int, device) -> Ladder:
    """The ladder of ``betas`` (validated by the caller) with cold-chain
    scale ``proposal_std`` (a scalar or ``[D]``), computed as the JAX
    package computes it: ``(1 / sqrt(beta_t)) * sigma_d`` in float32."""
    beta = torch.tensor(tuple(betas), dtype=torch.float32, device=device)
    sigma = torch.as_tensor(proposal_std, dtype=torch.float32)
    sigma = sigma.reshape(-1).to(device)
    if sigma.shape[0] not in (1, dim):
        raise ValueError(f"proposal_std must be a scalar or length {dim}; "
                         f"got shape {tuple(sigma.shape)}")
    sigma_l = (1.0 / torch.sqrt(beta))[:, None, None] * sigma[None, :, None]
    packed = torch.cat([beta, beta[:-1] - beta[1:],
                        sigma_l.expand(-1, dim, 1).reshape(-1)])
    return Ladder(beta, sigma_l, packed)


def pt_instance(target, n_temps: int, dim: int) -> int:
    """The kernel's target id; raises ``ValueError`` for a whitened
    target, a built-in (target, D) not instantiated (plain, or transformed
    for a transformed target) or a ladder longer than
    ``_build.PT_MAX_TEMPS``, naming what exists. A user density
    (``Target.cuda_source``, or the C++ generated from its batch form)
    runs in the value-only library of its own at D = 1-16
    (:func:`pt_lib`), id -1."""
    transformed = _build.unwhitened(target, "the tempering kernel")
    if target.cuda_functor is None:
        if n_temps > _build.PT_MAX_TEMPS:
            raise ValueError(f"the tempering kernel takes at most "
                             f"{_build.PT_MAX_TEMPS} rungs; got {n_temps}")
        if not 1 <= dim <= user_density.MAX_DIM:
            raise ValueError(f"user densities run in the tempering kernel "
                             f"at D <= {user_density.MAX_DIM}; got D={dim}")
        return -1
    return _pt_id(target.cuda_functor, n_temps, dim, transformed)


def pt_lib(target, n_temps: int, dim: int, device) -> tuple:
    """``(library, target id, target params)`` of a launch: the built-in
    library for a built-in functor, else the user density's value-only
    library (``user_density.value_lib``, shared with Kernel 5's isotropic
    walk)."""
    tid = pt_instance(target, n_temps, dim)
    if tid >= 0:
        return _build.lib(), tid, _build.params_ptr(target, device)
    handle, tparams = user_density.value_lib(target, None, dim, device)
    return handle, tid, tparams


@functools.cache
def _pt_id(functor: str | None, n_temps: int, dim: int,
           transformed: bool) -> int:
    tid = _build.form_id(functor, _build.FUNCTORS, "Target")
    if (functor, dim, transformed) not in _build.PT_INSTANCES:
        built = ", ".join(f"({t}, D={d}{', transformed' if tf else ''})"
                          for t, d, tf in _build.PT_INSTANCES)
        raise ValueError(f"the tempering kernel is built for (target, D) in "
                         f"{built}; got ({functor}, D={dim}"
                         f"{', transformed' if transformed else ''})")
    if n_temps > _build.PT_MAX_TEMPS:
        raise ValueError(f"the tempering kernel takes at most "
                         f"{_build.PT_MAX_TEMPS} rungs; got {n_temps}")
    return tid


def pt_draws(n_chains: int, n_temps: int, dim: int, n_inner: int,
             step: int, seed: int, device=None, chain0: int = 0):
    """One step's Philox draws, as the kernel takes them: ``n_inner``
    normals ``[T, D, C]``, ``n_inner`` accept uniforms ``[T, C]`` and the
    swap uniforms ``[T-1, C]``. Evaluation ``(chain, step, t, i)`` gives
    rung t's sweep i: words x, y its proposal normals 0 and 1 (the cosine
    and sine of one Box-Muller pair), word z its accept uniform, and at
    i = 0 word w the swap uniform of pair (t, t+1). Past D = 2 (the user
    instances, D <= 16), normals 2p and 2p + 1 come from words x, y of
    draw p T + t. Chain ``c`` draws as global chain ``chain0 + c``."""
    key = rng.seed_words(seed)
    chain = torch.arange(chain0, chain0 + n_chains, device=device) & _MASK
    rung = torch.arange(n_temps, device=device)[:, None]
    pair = torch.arange((dim + 1) // 2, device=device)[:, None, None]
    noises, us = [], []
    for i in range(n_inner):
        w = rng.philox4x32_10(chain, step, pair * n_temps + rung, i, key)
        normal = torch.stack(rng.box_muller_pair(w[0], w[1]), dim=2)
        noises.append(normal.permute(1, 0, 2, 3).reshape(
            n_temps, -1, n_chains)[:, :dim])
        us.append(rng.unit_open(w[2][0]))
        if i == 0:
            u_swap = rng.unit_open(w[3][0, :-1])
    return noises, us, u_swap


def pt_multistep_plain(target, pos, logp, swap_accept, parity: int,
                       lad: Ladder, seed: int, step0: int, k_steps: int,
                       n_inner: int, hist=None, *, chain0: int = 0):
    """Plain PyTorch twin of the kernel: :func:`ops.tempering.pt_step` on
    the kernel's Philox draws. Returns ``(pos', logp', swap_accept')``."""
    from ..tempering import PTState, pt_step  # that module imports this one

    pt_multistep_plain.calls += 1
    t, d, c = pos.shape
    state = PTState(pos, logp, parity, swap_accept)
    for k in range(k_steps):
        noises, us, u_swap = pt_draws(c, t, d, n_inner,
                                      (step0 + k) & _MASK, seed, pos.device,
                                      chain0)
        state = pt_step(target, state, lad.beta, lad.sigma_l, noises, us,
                        u_swap)
        if hist is not None:
            hist[k] = state.positions[0].T
    return state.positions, state.raw_logp, state.swap_accept


pt_multistep_plain.calls = 0


def pt_multistep(target, pos, logp, swap_accept, parity: int, lad: Ladder,
                 seed: int, step0: int, k_steps: int, n_inner: int,
                 hist=None, *, chain0: int = 0):
    """``k_steps`` PT steps of the ``[T, D, C]`` replica batch from global
    step ``step0``; returns ``(pos', logp', swap_accept')`` and writes the
    cold rung of each step into ``hist`` when given. ``chain0`` is the
    global index of the first chain: chain ``c`` draws as ``chain0 + c``."""
    if not pos.is_cuda:
        return pt_multistep_plain(target, pos, logp, swap_accept, parity,
                                  lad, seed, step0, k_steps, n_inner, hist,
                                  chain0=chain0)
    if pos.dim() != 3:
        raise ValueError(f"positions must be [T, D, C]; got "
                         f"{tuple(pos.shape)}")
    t, d, c = pos.shape
    lib, tid, tparams = pt_lib(target, t, d, pos.device)
    transformed = int(target.cuda_transform is not None)
    want = {"pos": (pos, (t, d, c)), "logp": (logp, (t, c)),
            "swap_accept": (swap_accept, (t - 1, c)),
            "ladder": (lad.packed, (t + t - 1 + t * d,))}
    for name, (x, shape) in want.items():
        if (x.shape != shape or x.dtype != torch.float32
                or x.device != pos.device or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {list(shape)} tensor "
                f"on {pos.device}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    hist_ptr, hist_sk, hist_sc = _build.hist_args(hist, k_steps, c, d,
                                                  torch.float32, pos.device)
    pos_o = torch.empty_like(pos)
    logp_o = torch.empty_like(logp)
    sa_o = torch.empty_like(swap_accept)
    seed_lo, seed_hi = rng.seed_words(seed)
    pt_multistep.launches += 1
    pt_multistep.transformed_launches += transformed
    pt_multistep.user_launches += tid < 0
    _build.check(lib.mm_pt_multistep(
        pos.data_ptr(), logp.data_ptr(), swap_accept.data_ptr(), tparams,
        lad.packed.data_ptr(), c, d, t, k_steps, n_inner, tid, transformed,
        parity % 2, chain0 & _MASK, seed_lo, seed_hi, step0 & _MASK,
        pos_o.data_ptr(),
        logp_o.data_ptr(), sa_o.data_ptr(), hist_ptr, hist_sk, hist_sc,
        _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, logp_o, sa_o


pt_multistep.launches = 0
pt_multistep.transformed_launches = 0
#: the launches of a user density's instance (its value-only library),
#: also counted in ``launches``
pt_multistep.user_launches = 0
