"""Kernel 6: K fused Gibbs sweeps per launch (``csrc/gibbs_multistep.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/gibbs_full.py:
make_pallas_gibbs_multistep`` and its K = 1 form without history. Per
sweep and chain, coordinate ``i = 0..D-1`` in order is drawn from its full
conditional given the state already updated at coordinates ``< i``, by the
conditional's built-in form (``csrc/conditionals.cuh``) or the user's
(``Conditional.cuda_source``, in a library of its own, :func:`gibbs_lib`;
its twin ``sample_words``); each post-sweep state is written to
``hist[k]``. float32 states only, as in the JAX package.

``hist``, ``seed``, ``step0`` and ``chain0`` are as in Kernel 5
(``mh_full.py``): a sweep draws one word stream per (chain, step)
(``rng.stream_words``), the conditional's words for all coordinates; the
mixture's three (x's normal from words 0 and 1, z's uniform from word 2)
are one Philox evaluation.

What bounds it on the H100: issue, in one dependent chain per thread
(``csrc/gibbs_multistep.cu``).

:func:`gibbs_multistep` launches the CUDA kernel for CUDA tensors and runs
:func:`gibbs_multistep_plain` for CPU tensors only.
"""

from __future__ import annotations

import functools

import torch

from ...models.mixture import mixture_coordinate
from . import _build, rng, user_density

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('GibbsSampler use_pallas="full" (Kernel 6)',
                   torch.float32)

_MASK = 0xFFFFFFFF


def _mixture_from_words(params, i, states, words):
    if i == 0:
        return mixture_coordinate(
            params, 0, states, rng.box_muller(words[:, 0], words[:, 1]),
            None)
    return mixture_coordinate(params, i, states, None,
                              rng.unit_open(words[:, 2]))


#: each built-in conditional as ``csrc/conditionals.cuh`` draws it from a
#: sweep's word stream: ``(words it reads at D, (cuda_params, i, states
#: [C, D], words [C, W]) -> coordinate i [C])``
SAMPLE_FROM_WORDS = {"gaussian_mixture": (lambda d: 3, _mixture_from_words)}


def sample_form(conditional) -> tuple:
    """``(words a sweep reads at D, (params, i, states, words) ->
    coordinate i)`` of ``conditional``'s fused form: a built-in's
    (``SAMPLE_FROM_WORDS``) or the user's ``cuda_words`` and
    ``sample_words``; raises naming the missing field."""
    if conditional.cuda_functor is not None:
        _build.conditional_id(conditional)  # raises for an unknown name
        return SAMPLE_FROM_WORDS[conditional.cuda_functor]
    if conditional.sample_words is None or conditional.cuda_words is None:
        raise ValueError(
            'use_pallas="full" needs a conditional with a built-in '
            "cuda_functor or its own fused form: Conditional.sample_words "
            "(the twin on Philox words) and Conditional.cuda_words, with "
            "Conditional.cuda_source for the CUDA kernel")
    return conditional.cuda_words, conditional.sample_words


def gibbs_instance(conditional, dim: int) -> int:
    """The kernel's conditional id; raises ``ValueError`` for a built-in
    conditional not instantiated at ``dim``, naming the instances that
    exist. A user conditional (``cuda_source`` and its twin) runs in a
    library of its own at D <= 16 (:func:`gibbs_lib`), id -1. Resolved
    once per (form, D), then read from a cache on every launch."""
    if conditional.cuda_functor is None:
        sample_form(conditional)
        user_density.source_of(conditional, "Conditional")
        if not 1 <= dim <= user_density.MAX_DIM:
            raise ValueError(f"user conditionals run in the Gibbs kernel at "
                             f"D <= {user_density.MAX_DIM}; got D={dim}")
        return -1
    return _gibbs_id(conditional.cuda_functor, dim)


def gibbs_lib(conditional, dim: int) -> tuple:
    """``(library, conditional id)`` of a launch: the built-in library, or
    the user conditional's own (``user_density.gibbs_spec``: its source at
    ``dim``), built if need be."""
    cid = gibbs_instance(conditional, dim)
    if cid >= 0:
        return _build.lib(), cid
    return _user_lib(conditional, dim), cid


@functools.lru_cache(maxsize=64)
def _user_lib(conditional, dim: int):
    return user_density.lib_for(*user_density.gibbs_spec(conditional, dim))


@functools.cache
def _gibbs_id(name: str | None, dim: int) -> int:
    cid = _build.form_id(name, _build.CONDITIONALS, "Conditional")
    if (name, dim) not in _build.GIBBS_INSTANCES:
        built = ", ".join(f"({n}, D={d})" for n, d in _build.GIBBS_INSTANCES)
        raise ValueError(f"the Gibbs kernel is built for (conditional, D) in "
                         f"{built}; got ({name}, D={dim})")
    return cid


def gibbs_multistep_plain(conditional, pos, seed: int, step0: int,
                          k_steps: int, hist=None, *, chain0: int = 0,
                          words=None):
    """Plain PyTorch twin of the kernel, drawing the same Philox words.

    ``words``, int64 ``[K, C, W]``, replace each sweep's word stream.
    Returns ``pos'``.
    """
    gibbs_multistep_plain.calls += 1
    words_of, sample = sample_form(conditional)
    c, d = pos.shape
    for k in range(k_steps):
        if words is None:
            w = rng.stream_words(c, words_of(d), (step0 + k) & _MASK, seed,
                                 pos.device, chain0)
        else:
            w = words[k]
        pos = pos.clone()
        for i in range(d):
            pos[:, i] = sample(conditional.cuda_params, i, pos, w)
        if hist is not None:
            hist[k] = pos
    return pos


gibbs_multistep_plain.calls = 0


def gibbs_multistep(conditional, pos, seed: int, step0: int, k_steps: int,
                    hist=None, *, chain0: int = 0):
    """``k_steps`` Gibbs sweeps of ``conditional`` from ``pos [C, D]``;
    returns ``pos'`` and writes each post-sweep state into ``hist`` when
    given."""
    if not pos.is_cuda:
        return gibbs_multistep_plain(conditional, pos, seed, step0, k_steps,
                                     hist, chain0=chain0)
    if pos.dim() != 2:
        raise ValueError(f"positions must be [C, D]; got {tuple(pos.shape)}")
    c, d = pos.shape
    lib, cid = gibbs_lib(conditional, d)
    if pos.dtype != torch.float32 or not pos.is_contiguous():
        raise ValueError("the Gibbs kernel takes contiguous float32 "
                         f"positions; got {pos.dtype}")
    hist_ptr, hist_sk, hist_sc = _build.hist_args(hist, k_steps, c, d,
                                                  torch.float32, pos.device)
    pos_o = torch.empty_like(pos)
    seed_lo, seed_hi = rng.seed_words(seed)
    gibbs_multistep.launches += 1
    gibbs_multistep.user_launches += cid < 0
    _build.check(lib.mm_gibbs_multistep(
        pos.data_ptr(), _build.params_ptr(conditional, pos.device), k_steps,
        c, d, cid, chain0 & _MASK, seed_lo, seed_hi, step0 & _MASK,
        pos_o.data_ptr(), hist_ptr, hist_sk, hist_sc,
        _build.stream_ptr(pos.device),
    ), lib)
    return pos_o


gibbs_multistep.launches = 0
#: the launches of a user conditional's instance, also counted in
#: ``launches``
gibbs_multistep.user_launches = 0
