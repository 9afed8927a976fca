"""Kernel 2: K whole HMC steps per launch (``csrc/hmc_multistep.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/hmc_full.py:make_pallas_hmc_multistep``
and its K = 1 case ``make_pallas_hmc_step`` (``hist=None``). Per step and
chain: momentum from the (chain, step)'s Philox word stream
(``rng.stream_words``: normals ``2p`` and ``2p + 1`` the cosine and sine of
one Box-Muller angle on words ``2p`` and ``2p + 1``, the accept uniform
word ``2 ceil(D / 2)``; one Philox evaluation a step at D <= 2, two at
D = 3, 4), L leapfrog steps at ``eps[k]``, the accept ``(h_cur - h_prop)
>= log(u)`` with true selects, and the kept position written to
``hist[k]``.

``chain0`` is the global index of the launch's first chain (a shard's
offset under a chain mesh): chain ``c`` draws from the stream of chain
``chain0 + c``, so the rows of one launch over all chains equal those of
launches over any split of them.

``hist`` is a ``[K, C, D]`` view into the runner's preallocated sample cube
(time-major or chain-major; any strides with a unit D stride), written in
place. ``eps [K]`` lives on the positions' device. ``seed`` is the run's
64-bit Philox key and ``step0`` the global step index of the block's first
step, so the draws do not depend on how steps are grouped into blocks.

:func:`hmc_multistep` launches the CUDA kernel for CUDA tensors and runs
:func:`hmc_multistep_plain` for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import _build, rng
from .hmc import check_state, leapfrog_trajectory_plain

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('HMC/MALA use_pallas="full" (Kernel 2)', torch.float32)


def hmc_multistep_plain(target, pos, logp, grad, eps, n_leapfrog: int,
                        seed: int, step0: int, hist=None, *, mom=None,
                        u=None, chain0: int = 0):
    """Plain PyTorch twin of the kernel, drawing the same Philox stream.

    ``mom [K, C, D]`` and ``u [K, C]``, given together, replace the
    Philox draws (parity tests feed both packages the same numbers).
    Returns ``(pos', logp', grad')``.
    """
    hmc_multistep_plain.calls += 1
    c, d = pos.shape
    accept_word = 2 * ((d + 1) // 2)
    for k in range(eps.shape[0]):
        if mom is None:
            w = rng.stream_words(c, accept_word + 1, (step0 + k) & 0xFFFFFFFF,
                                 seed, pos.device, chain0)
            m = rng.pair_normals(w, d)
            uk = rng.unit_open(w[:, accept_word])
        else:
            m, uk = mom[k], u[k]
        h_cur = -logp + 0.5 * torch.sum(m * m, dim=1)
        p, m, lp, g = leapfrog_trajectory_plain(target, pos, m, grad, eps[k],
                                                n_leapfrog)
        h_prop = -lp + 0.5 * torch.sum(m * m, dim=1)
        accept = (h_cur - h_prop) >= torch.log(uk)  # NaN compares False
        pos = torch.where(accept[:, None], p, pos)
        grad = torch.where(accept[:, None], g, grad)
        logp = torch.where(accept, lp, logp)
        if hist is not None:
            hist[k] = pos
    return pos, logp, grad


hmc_multistep_plain.calls = 0


def hmc_multistep(target, pos, logp, grad, eps, n_leapfrog: int, seed: int,
                  step0: int, hist=None, *, chain0: int = 0):
    """K = ``len(eps)`` HMC steps of ``target``; returns
    ``(pos', logp', grad')`` and writes the K kept rows into ``hist``."""
    if not pos.is_cuda:
        return hmc_multistep_plain(target, pos, logp, grad, eps, n_leapfrog,
                                   seed, step0, hist, chain0=chain0)
    check_state(pos, logp, grad, eps, tier=TIER,
                dims=_build.kernel_dims(target))
    lib, tid, params = _build.kernel_lib(target, pos.shape[1], pos.device)
    c, d = pos.shape
    k = eps.shape[0]
    if (eps.dim() != 1 or logp.shape != (c,) or grad.shape != pos.shape):
        raise ValueError("expected pos/grad [C, D], logp [C] and eps [K]")
    hist_ptr, hist_sk, hist_sc = _build.hist_args(hist, k, c, d,
                                                  torch.float32, pos.device)
    pos_o = torch.empty_like(pos)
    grad_o = torch.empty_like(pos)
    logp_o = torch.empty_like(logp)
    seed_lo, seed_hi = rng.seed_words(seed)
    hmc_multistep.launches += 1
    hmc_multistep.transformed_launches += (
        target.cuda_transform is not None)
    hmc_multistep.user_launches += target.cuda_functor is None
    _build.check(lib.mm_hmc_multistep_f32(
        pos.data_ptr(), logp.data_ptr(), grad.data_ptr(), eps.data_ptr(),
        params, k, n_leapfrog, c, d, tid, _build.instance_flags(target),
        chain0 & 0xFFFFFFFF, seed_lo, seed_hi, step0 & 0xFFFFFFFF,
        pos_o.data_ptr(), logp_o.data_ptr(), grad_o.data_ptr(), hist_ptr, hist_sk, hist_sc,
        _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, logp_o, grad_o


hmc_multistep.launches = 0
#: the launches of the transformed instances (``mm::Transformed``, a
#: metric's wrapper around it included), also counted in ``launches``
hmc_multistep.transformed_launches = 0
#: the launches of user instances (``user_density.py``), also counted in
#: ``launches``
hmc_multistep.user_launches = 0
