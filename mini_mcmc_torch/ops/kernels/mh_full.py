"""Kernel 5: K fused Metropolis-Hastings steps per launch
(``csrc/mh_multistep.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/mh_full.py:make_pallas_mh_multistep``
and its K = 1 form without history. Per step and chain: a symmetric
proposal drawn from the Philox stream by the proposal's built-in form
(``csrc/proposals.cuh``) or the user's (``Proposal.cuda_source``), the
target's logp there (``csrc/targets.cuh``, or a user density's value:
``Target.cuda_source`` or the C++ generated from its batch form), the
strict accept ``(lp' - lp) > log(u)`` with true selects, and the kept
position written to ``hist[k]``. A user form runs in a library of its own,
the value-only table of ``user_density.py`` (:func:`mh_lib`), float32 or
int32 states at D <= 16 (an int32 density is value-only C++ on int32
states with a float32 logp, ``csrc/user_density.cuh``; an int32 proposal
reads and writes int32 states, ``csrc/proposals.cuh``); the twin draws a
user proposal through ``propose_words``, as the JAX package's one
``propose_dc`` serves its kernel and interpret mode.

Positions are float32 or int32 (discrete targets); the cached logp is
float32. A transformed target (``transform=``) runs the float32 instances
inside ``targets.cuh:Transformed``: the walk in the unconstrained y, the
density ``logp(g(y)) + log|g'(y)|``, the twin's ``target.batch_logp`` of
the wrapped target; its launches are also counted in
``mh_multistep.transformed_launches``. ``hist`` is a ``[K, C, D]`` view
into the runner's preallocated cube (any strides with a unit D stride),
written in place. ``seed`` is the
run's 64-bit Philox key, ``step0`` the global step of the block's first
step and ``chain0`` the index of the first chain, so the draws depend on
neither the grouping of steps into blocks nor a split of the chains.

Draws: one word stream per (chain, step) (``rng.stream_words``): the
proposal's words (``2 ceil(D / 2)`` for the isotropic walk, its normals
in Box-Muller pairs; ``D`` coins for the integer walk), then the accept
uniform's word, so a Gaussian2D or Poisson step is one Philox evaluation.

What bounds it on the H100: issue, in one dependent chain per thread
(``csrc/mh_multistep.cu``): a Gaussian2D step is one Philox evaluation
and one Box-Muller pair, about half the instructions of one evaluation
per draw.

:func:`mh_multistep` launches the CUDA kernel for CUDA tensors and runs
:func:`mh_multistep_plain` for CPU tensors only.
"""

from __future__ import annotations

import functools

import torch

from ...models.discrete import int_walk
from . import _build, rng, user_density

_MASK = 0xFFFFFFFF
#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('MetropolisHastings use_pallas="full" (Kernel 5)',
                   torch.float32, torch.int32)


def _isotropic_from_words(params, current, words):
    return current + params[0] * rng.pair_normals(words, current.shape[1])


def _int_walk_from_words(params, current, words):
    clip_low, clip_high, has_high = params
    return int_walk(current, words[:, :current.shape[1]] < 2**31,
                    int(clip_low), int(clip_high) if has_high else None)


#: each built-in proposal as ``csrc/proposals.cuh`` draws it from a step's
#: word stream: ``(words it reads at D, (cuda_params, current [C, D],
#: words [C, W]) -> proposed [C, D])``; the accept takes the next word
PROPOSE_FROM_WORDS = {
    "isotropic_gaussian": (lambda d: 2 * ((d + 1) // 2),
                           _isotropic_from_words),
    "random_walk_int": (lambda d: d, _int_walk_from_words),
}


def propose_form(proposal) -> tuple:
    """``(words it reads at D, (params, current, words) -> proposed)`` of
    ``proposal``'s fused form: a built-in's (``PROPOSE_FROM_WORDS``) or the
    user's ``cuda_words`` and ``propose_words``; raises naming the missing
    field."""
    if proposal.cuda_functor is not None:
        _build.proposal_id(proposal)  # raises for an unknown name
        return PROPOSE_FROM_WORDS[proposal.cuda_functor]
    if proposal.propose_words is None or proposal.cuda_words is None:
        raise ValueError(
            'use_pallas="full" needs a proposal with a built-in '
            "cuda_functor or its own fused form: Proposal.propose_words "
            "(the twin on Philox words) and Proposal.cuda_words, with "
            "Proposal.cuda_source for the CUDA kernel")
    return proposal.cuda_words, proposal.propose_words


def user_forms(target, proposal) -> bool:
    """Whether the pair runs in a per-form library of its own (a user
    density or a user proposal) rather than the built-in one."""
    return target.cuda_functor is None or proposal.cuda_functor is None


def mh_instance(target, proposal, dtype, dim: int) -> tuple[int, int, int]:
    """The kernel's (target, proposal, state type) ids; raises
    ``ValueError`` for a whitened target, a pair without a CUDA form or
    one not instantiated at ``dtype`` and ``dim`` (plain, or transformed
    for a transformed target), naming the instances that exist. A user
    density (``cuda_source``, or generated from the batch form) or a user
    proposal (``cuda_source``) runs in a library of its own
    (:func:`mh_lib`, float32 or int32 states, D <= 16; an int32 one takes
    no transform), ids ``(-1, -1, state type)``. Resolved once per
    (forms, dtype, D, transformed), then read from a cache on every
    launch."""
    transformed = _build.unwhitened(target, "the MH kernel")
    if user_forms(target, proposal):
        propose_form(proposal)
        if proposal.cuda_functor is None:
            user_density.source_of(proposal, "Proposal")
        _build.check_tier_dtype(TIER, dtype)
        if dtype == torch.int32 and transformed:
            raise ValueError("an integer state takes no transform: the MH "
                             "kernel's int32 instances run no bijector")
        if not 1 <= dim <= user_density.MAX_DIM:
            raise ValueError(f"user forms run in the MH kernel at D <= "
                             f"{user_density.MAX_DIM}; got D={dim}")
        return -1, -1, _build.STATE_TYPES[dtype]
    return _mh_ids(target.cuda_functor, proposal.cuda_functor, dtype, dim,
                   transformed)


def mh_lib(target, proposal, dtype, dim: int, device) -> tuple:
    """``(library, target id, proposal id, state type, target params,
    proposal params)`` of a launch: the built-in library for a built-in
    pair, else the value-only library of the pair
    (``user_density.value_lib``: Kernel 5's instance of the user density
    or built-in functor beside the user or built-in proposal)."""
    tid, pid, st = mh_instance(target, proposal, dtype, dim)
    pparams = _build.params_ptr(proposal, device)
    if tid >= 0:
        return (_build.lib(), tid, pid, st,
                _build.params_ptr(target, device), pparams)
    handle, tparams = user_density.value_lib(target, proposal, dim, device,
                                             dtype)
    return handle, tid, pid, st, tparams, pparams


@functools.cache
def _mh_ids(target: str | None, proposal: str | None, dtype, dim: int,
            transformed: bool) -> tuple[int, int, int]:
    tid = _build.form_id(target, _build.FUNCTORS, "Target")
    pid = _build.form_id(proposal, _build.PROPOSALS, "Proposal")
    if (target, proposal, dtype, dim, transformed) not in (
            _build.MH_INSTANCES):
        built = ", ".join(
            f"({t}, {p}, {_build.dtype_name(dt)}, D={d}"
            f"{', transformed' if tf else ''})"
            for t, p, dt, d, tf in _build.MH_INSTANCES)
        raise ValueError(
            "the MH kernel is built for (target, proposal, state dtype, D) "
            f"in {built}; got ({target}, {proposal}, "
            f"{_build.dtype_name(dtype)}, D={dim}"
            f"{', transformed' if transformed else ''})")
    return tid, pid, _build.STATE_TYPES[dtype]


def mh_multistep_plain(target, proposal, pos, logp, seed: int, step0: int,
                       k_steps: int, hist=None, *, chain0: int = 0,
                       words=None):
    """Plain PyTorch twin of the kernel, drawing the same Philox words.

    ``words``, int64 ``[K, C, W]``, replace each step's word stream
    (parity tests feed both packages the same draws). Returns
    ``(pos', logp')``.
    """
    mh_multistep_plain.calls += 1
    words_of, propose = propose_form(proposal)
    c, d = pos.shape
    accept_word = words_of(d)
    for k in range(k_steps):
        if words is None:
            w = rng.stream_words(c, accept_word + 1, (step0 + k) & _MASK,
                                 seed, pos.device, chain0)
        else:
            w = words[k]
        prop = propose(proposal.cuda_params, pos, w)
        lp = target.batch_logp(prop)
        u = rng.unit_open(w[:, accept_word])
        accept = (lp - logp) > torch.log(u)  # NaN compares False
        pos = torch.where(accept[:, None], prop, pos)
        logp = torch.where(accept, lp, logp)
        if hist is not None:
            hist[k] = pos
    return pos, logp


mh_multistep_plain.calls = 0


def mh_multistep(target, proposal, pos, logp, seed: int, step0: int,
                 k_steps: int, hist=None, *, chain0: int = 0):
    """``k_steps`` MH steps of ``target`` under ``proposal`` from
    ``(pos [C, D], logp [C])``; returns ``(pos', logp')`` and writes the
    kept rows into ``hist`` when given."""
    if not pos.is_cuda:
        return mh_multistep_plain(target, proposal, pos, logp, seed, step0,
                                  k_steps, hist, chain0=chain0)
    if pos.dim() != 2:
        raise ValueError(f"positions must be [C, D]; got {tuple(pos.shape)}")
    c, d = pos.shape
    lib, tid, pid, state_type, tparams, pparams = mh_lib(
        target, proposal, pos.dtype, d, pos.device)
    transformed = int(target.cuda_transform is not None)
    if (logp.shape != (c,) or logp.dtype != torch.float32
            or logp.device != pos.device):
        raise ValueError(f"logp must be float32 [{c}] on {pos.device}; got "
                         f"{logp.dtype} {tuple(logp.shape)} on {logp.device}")
    if not (pos.is_contiguous() and logp.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")
    hist_ptr, hist_sk, hist_sc = _build.hist_args(hist, k_steps, c, d,
                                                  pos.dtype, pos.device)
    pos_o = torch.empty_like(pos)
    logp_o = torch.empty_like(logp)
    seed_lo, seed_hi = rng.seed_words(seed)
    mh_multistep.launches += 1
    mh_multistep.transformed_launches += transformed
    mh_multistep.user_launches += tid < 0
    _build.check(lib.mm_mh_multistep(
        pos.data_ptr(), logp.data_ptr(), tparams, pparams, k_steps, c, d,
        tid, pid, state_type, transformed, chain0 & _MASK, seed_lo, seed_hi,
        step0 & _MASK,
        pos_o.data_ptr(), logp_o.data_ptr(), hist_ptr, hist_sk, hist_sc,
        _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, logp_o


mh_multistep.launches = 0
mh_multistep.transformed_launches = 0
#: the launches of a per-form library's instance (a user density or
#: proposal), also counted in ``launches``
mh_multistep.user_launches = 0
