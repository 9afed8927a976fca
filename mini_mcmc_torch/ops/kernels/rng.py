"""Kernel 0: the Philox4x32-10 stream the fused kernels draw from.

Replaces the TPU hardware PRNG helpers of ``mini_mcmc_tpu/ops/pallas/rng.py``
(``uniform``, ``normals``, ``bits_to_unit_open``). The device side is
``csrc/philox.cuh``; this module is its plain PyTorch twin, computing the
same rounds in ``int64`` arithmetic masked to 32 bits, so both give the same
bits for the same (key, counter). The TPU stream is not reproduced: the
port's stream is its own, distribution-identical, and fixed by
(seed, chain, step, draw) alone.

Counter layout: ``(chain index, global step, draw index, sub-draw)``; the
key is the full 64-bit per-run seed as two words. NUTS
(Kernel 4): draw 0 the momentum by paired Box-Muller (words x, y) and the
slice's Exp(1) uniform (word z) at D <= 2, at D > 2 draws ``0..Q-1`` the
momenta four to an evaluation and draw ``Q = ceil(D / 4)``'s word x the
slice; draw ``0x10000 + j``, sub-draw 0, doubling ``j``'s direction and
progressive-accept uniforms (words x, y), sub-draw ``1 + q`` its merge
uniforms of ordinals ``4q..4q+3``, the merge at leaf ``i``, cascade
position ``k`` having ordinal ``i - popcount(i) + k``
(``nuts_full.py``). The ``use_pallas=True`` NUTS tier takes its
subtree hash seeds from chain 0, draw ``0x20000 + j``, and the plain NUTS
tiers seed each step's ``torch.Generator`` from chain 0, draw ``0x30000``
(``ops/nuts.py``). HMC (Kernel 2), MH (Kernel 5) and Gibbs (Kernel 6):
one word stream per (chain, step), the words of the counters ``(chain,
step, q, 0)`` for ``q < ceil(W / 4)`` in order (:func:`stream_words`),
``W`` the words the step uses. HMC and the isotropic walk take normals
``2p``, ``2p + 1`` from the cosine and sine of :func:`box_muller_pair` on
words ``2p``, ``2p + 1`` (:func:`pair_normals`) and the accept from word
``2 ceil(D / 2)``; the integer walk coin ``d``
from the top bit of word ``d`` (clear meaning +1) and the accept from
word ``D``; the Gibbs mixture x's normal from :func:`box_muller` on words
0, 1 and z's uniform from word 2. Separable HMC (Kernel 7): draw ``q``
gives the momenta of coordinates ``4q..4q+3`` by paired Box-Muller
(:func:`paired_normals`), draw 0, sub-draw 1, word x the accept uniform.
Parallel tempering (Kernel 8): draw ``t``,
sub-draw ``i`` gives rung ``t``'s sweep ``i``, words x, y its proposal
normal, word z its accept, and at ``i = 0`` word w the swap uniform of
pair ``(t, t+1)``.
The full table is in ``csrc/philox.cuh``.
"""

from __future__ import annotations

import torch

from . import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def seed_words(seed: int) -> tuple[int, int]:
    """A 64-bit seed as the two 32-bit key words (low, high)."""
    return seed & _MASK, (seed >> 32) & _MASK


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` for ``a < 2**32`` held in
    int64, without overflowing it: ``m`` is split into 16-bit halves."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & _MASK


def philox4x32_10(c0, c1, c2, c3, key: tuple[int, int]):
    """Philox4x32-10 on int64 tensors of 32-bit counter words (broadcast
    together); returns the four output words as int64 in [0, 2**32)."""
    device = next((c.device for c in (c0, c1, c2, c3)
                   if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*(
        torch.as_tensor(c, dtype=torch.int64, device=device)
        for c in (c0, c1, c2, c3)
    ))
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_words(c0: int, c1: int, c2: int, c3: int,
                 seed: int) -> tuple[int, int, int, int]:
    """Philox4x32-10 of one counter on Python ints, for the host: the
    same words as :func:`philox4x32_10` without a tensor."""
    k0, k1 = seed_words(seed)
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def unit_open(bits: torch.Tensor) -> torch.Tensor:
    """``rng.py:bits_to_unit_open``: top 24 bits to f32 in (0, 1), never 0."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) + (
        1.0 / 33554432.0
    )


def box_muller(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``rng.py:normals``: Box-Muller, cos branch, from two bit words."""
    u1 = unit_open(a)
    u2 = unit_open(b)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)


def box_muller_pair(a: torch.Tensor, b: torch.Tensor):
    """``rng.py:normals_paired``: the cosine and sine normals of one
    Box-Muller angle, from two bit words."""
    r = torch.sqrt(-2.0 * torch.log(unit_open(a)))
    angle = _TWO_PI * unit_open(b)
    return r * torch.cos(angle), r * torch.sin(angle)


def stream_words(n_chains: int, n_words: int, step: int, seed: int,
                 device=None, chain0: int = 0, q0: int = 0) -> torch.Tensor:
    """One step's word stream for every chain (``philox.cuh:step_words``,
    Kernels 2, 5 and 6): int64 ``[C, 4 ceil(n_words / 4)]``, word ``4q + j``
    being word ``j`` of the counter ``(chain0 + c, step, q0 + q, 0)``."""
    chain = torch.arange(chain0, chain0 + n_chains,
                         device=device).reshape(-1, 1)
    quad = torch.arange(q0, q0 + (n_words + 3) // 4,
                        device=device).reshape(1, -1)
    w = philox4x32_10(chain, step, quad, 0, seed_words(seed))
    return torch.stack(w, dim=2).reshape(n_chains, -1)


def pair_normals(words: torch.Tensor, dim: int) -> torch.Tensor:
    """``[C, dim]`` normals from a word stream ``[C, W]``: normals ``2p``
    and ``2p + 1`` are the cosine and sine of :func:`box_muller_pair` on
    words ``2p`` and ``2p + 1``."""
    n_pairs = (dim + 1) // 2
    cos, sin = box_muller_pair(words[:, 0:2 * n_pairs:2],
                               words[:, 1:2 * n_pairs:2])
    return torch.stack((cos, sin), dim=2).reshape(len(words), -1)[:, :dim]


def paired_normals(n_chains: int, dim: int, step: int, seed: int,
                   device=None, chain0: int = 0, d0: int = 0) -> torch.Tensor:
    """``[C, D]`` momenta of the separable kernel (``philox.cuh``,
    Kernel 7): the counter ``(chain0 + c, step, q, 0)`` gives coordinates
    ``4q..4q+3``, words x and y the cosine and sine of one Box-Muller pair,
    words z and w of the next. ``d0`` (a multiple of 4) places the D
    columns at global coordinates ``d0 ..``: the columns of a wider
    state's momenta."""
    if d0 % 4:
        raise ValueError(f"a D-slice starts at a multiple of 4; got d0={d0}")
    return pair_normals(
        stream_words(n_chains, dim, step, seed, device, chain0, d0 // 4), dim)


def uniform_at(chain, step: int, draw: int, seed: int, sub=0):
    """``philox.cuh:uniform_at``: word x of the counter
    ``(chain, step, draw, sub)`` as a uniform in (0, 1); ``chain`` and
    ``sub`` broadcast as int64 tensors."""
    w0, _, _, _ = philox4x32_10(chain, step, draw, sub, seed_words(seed))
    return unit_open(w0)


def philox_fill_plain(n: int, c1: int, c2: int, seed: int,
                      device=None) -> torch.Tensor:
    """``[n, 4]`` Philox words (int64) for counters ``(i, c1, c2, 0)``."""
    i = torch.arange(n, device=device)
    return torch.stack(philox4x32_10(i, c1, c2, 0, seed_words(seed)), dim=1)


def philox_fill(n: int, c1: int, c2: int, seed: int,
                device=None) -> torch.Tensor:
    """The Philox words of ``csrc/philox.cuh`` for counters
    ``(i, c1, c2, 0)``, ``i < n``, as int64 ``[n, 4]``. Launches the CUDA
    kernel for a CUDA device, else runs :func:`philox_fill_plain`."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return philox_fill_plain(n, c1, c2, seed, device)
    k0, k1 = seed_words(seed)
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    lib = _build.lib()
    philox_fill.launches += 1
    _build.check(lib.mm_philox_fill(out.data_ptr(), n, c1 & _MASK,
                                    c2 & _MASK, k0, k1,
                                    _build.stream_ptr(device)))
    return out.to(torch.int64) & _MASK


philox_fill.launches = 0
