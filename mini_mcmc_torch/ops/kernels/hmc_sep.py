"""Kernel 7: the separable HMC tier's trajectory (``csrc/hmc_separable.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/hmc_bigd.py:make_pallas_hmc_separable``
(its production form and the ``mom_input`` debug form). For a density that
is a sum over coordinates, every coordinate follows the leapfrog on its
own: the kernel draws the momentum (paired Box-Muller from the Philox
stream, ``rng.paired_normals``), runs the merged-kick leapfrog with the
coordinate functor's derivative, and returns per chain ``logp(pos_prop)``
and the kinetic energies before and after. The accept stays outside, in
``ops/hmc.py``, as the JAX package leaves it to XLA.

The kernel evaluates the target's coordinate functor
(``Target.cuda_functor``, ``_build.SEP_FUNCTORS``, ``csrc/coord_targets.cuh``)
on its ``[n_tables, D]`` tables; the twin evaluates the Python
``Target.sep_forms()`` density on the same tables and takes the gradient
by autograd, as the TPU kernel takes it by AD inside each tile. A target
whitened by a diagonal metric (``Target.cuda_scaled``) runs the functor's
scaled instance (``coord_targets.cuh:Scaled``), the scale its last table,
as the TPU kernel runs the whitened ``sep_form`` with ``n_tables`` one
larger.

What bounds it on the H100: bytes at L = 10 (82 MB per step at C = 1,024,
D = 10,000), instructions at L = 40; no ``[C, D]`` momentum or gradient is
stored. :func:`hmc_separable` launches the kernel for CUDA tensors and runs
:func:`hmc_separable_plain` for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import _build, rng

_MASK = 0xFFFFFFFF
#: quads of four coordinates per thread (csrc/hmc_separable.cu:kSepGroups)
SEP_GROUPS = 2
#: threads per block of a launch (the kernel takes 32..256)
SEP_THREADS = 256


def sep_tiles(dim: int, threads: int = SEP_THREADS) -> int:
    """The kernel's D-tiles per chain: ``ceil(ceil(D / 4) / (threads *
    SEP_GROUPS))``."""
    per_tile = threads * SEP_GROUPS
    return ((dim + 3) // 4 + per_tile - 1) // per_tile


def sep_functor(target) -> tuple[int, int]:
    """``(functor id, number of tables)`` of ``target``'s coordinate
    functor. A target whitened once by a diagonal metric
    (``Target.cuda_scaled``) runs the functor's scaled instance, its
    tables the functor's own and the scale. Raises ``ValueError`` for a
    target without a functor and for any other whitened target (a dense
    metric, or one whitened twice)."""
    fid, n_tables = _build.form_id(target.cuda_functor, _build.SEP_FUNCTORS,
                                   "Target")
    if not target.cuda_affine:
        return fid, n_tables
    n_whitened = len(target.sep_forms()[1])
    if not target.cuda_scaled or n_whitened != n_tables + 1:
        raise ValueError(
            "HMC(use_pallas='separable') runs a whitened target on CUDA "
            "only when one diagonal metric whitens it once (its sep_form "
            f"tables: the functor's {n_tables} and the scale); got "
            f"{n_whitened} tables, cuda_scaled={target.cuda_scaled}")
    return fid, n_tables + 1


def _tile_grad(fn, x, tables):
    """Gradient of the slice density ``fn`` w.r.t. the positions only, by
    autograd (rows and coordinates are independent)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(x, *tables).sum(), x)
    return g


def hmc_separable_plain(target, pos, eps, n_leapfrog: int, seed: int,
                        step: int, tables, mom=None, *, chain0: int = 0):
    """Plain PyTorch twin of the kernel. ``tables`` is the ``[n_tables,
    D]`` tensor of the target's ``sep_forms()`` tables and ``eps`` a
    one-element tensor. ``mom [C, D]`` replaces the Philox momentum (the
    debug form). Returns ``(pos_prop, logp_prop [C], ke0 [C], ke1 [C],
    mom_prop)``; ``mom_prop`` is ``None`` without ``mom``."""
    hmc_separable_plain.calls += 1
    fn, _ = target.sep_forms()
    tabs = tuple(tables[i:i + 1] for i in range(tables.shape[0]))
    c, d = pos.shape
    if mom is None:
        mom0 = rng.paired_normals(c, d, step & _MASK, seed, pos.device,
                                  chain0).to(pos.dtype)
    else:
        mom0 = mom
    eps = eps.reshape(-1)[0]
    half = eps * 0.5
    x = pos
    m = mom0 + _tile_grad(fn, x, tabs) * half
    for i in range(n_leapfrog):
        x = x + eps * m
        m = m + _tile_grad(fn, x, tabs) * (eps if i < n_leapfrog - 1
                                           else half)
    logp = fn(x, *tabs).detach().to(pos.dtype)
    ke0 = 0.5 * torch.sum(mom0 * mom0, dim=1)
    ke1 = 0.5 * torch.sum(m * m, dim=1)
    return x, logp, ke0, ke1, (m if mom is not None else None)


hmc_separable_plain.calls = 0


def hmc_separable(target, pos, eps, n_leapfrog: int, seed: int, step: int,
                  tables, mom=None, *, chain0: int = 0,
                  threads: int = SEP_THREADS):
    """One trajectory per chain of ``pos [C, D]`` at step size ``eps`` (a
    one-element tensor on the positions' device), drawing the momentum at
    ``(seed, chain0 + c, step)`` unless ``mom`` is given. Returns
    ``(pos_prop, logp_prop, ke0, ke1, mom_prop)`` as
    :func:`hmc_separable_plain`. ``threads`` sets the launch's block size
    and so its D-tiles; the results do not depend on it beyond the order
    of the sums."""
    if not pos.is_cuda:
        return hmc_separable_plain(target, pos, eps, n_leapfrog, seed, step,
                                   tables, mom, chain0=chain0)
    fid, n_tables = sep_functor(target)
    scaled = target.cuda_scaled
    if pos.dim() != 2 or pos.dtype != torch.float32:
        raise ValueError("the separable kernel takes float32 [C, D] "
                         f"positions; got {pos.dtype} {tuple(pos.shape)}")
    c, d = pos.shape
    if tables.shape != (n_tables, d) or tables.dtype != torch.float32:
        raise ValueError(
            f"coordinate functor {target.cuda_functor!r} reads {n_tables} "
            f"float32 [1, {d}] tables; got {tables.dtype} "
            f"{tuple(tables.shape)}")
    if mom is not None and (mom.shape != pos.shape
                            or mom.dtype != torch.float32):
        raise ValueError("mom must be float32 like pos")
    if eps.numel() != 1 or eps.dtype != torch.float32:
        raise ValueError("eps must be a one-element float32 tensor")
    ins = [t for t in (pos, eps, tables, mom) if t is not None]
    if any(t.device != pos.device or not t.is_contiguous() for t in ins):
        raise ValueError("the CUDA kernels take contiguous tensors on the "
                         "positions' device")
    if threads % 32 or not 32 <= threads <= SEP_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{SEP_THREADS}]; got {threads}")
    pos_o = torch.empty_like(pos)
    mom_o = None if mom is None else torch.empty_like(pos)
    parts = torch.empty((3, c, sep_tiles(d, threads)), dtype=torch.float32,
                        device=pos.device)
    # the float4 path needs every row 16-byte aligned, each table row too
    # (row 1 starts D floats after row 0)
    vec = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (
        pos, pos_o, *tables, *(() if mom is None else (mom, mom_o)))))
    seed_lo, seed_hi = rng.seed_words(seed)
    lib = _build.lib()
    hmc_separable.launches += 1
    hmc_separable.scaled_launches += int(scaled)
    _build.check(lib.mm_hmc_separable(
        pos.data_ptr(), None if mom is None else mom.data_ptr(),
        eps.data_ptr(), _build.params_ptr(target, pos.device, d),
        tables.data_ptr() if n_tables else None, c, d, n_leapfrog, fid,
        int(scaled), threads, vec, chain0 & _MASK, seed_lo, seed_hi,
        step & _MASK,
        pos_o.data_ptr(), None if mom_o is None else mom_o.data_ptr(),
        parts.data_ptr(), _build.stream_ptr(pos.device),
    ))
    logp, ke0, ke1 = parts.sum(dim=2)
    return pos_o, logp, ke0, ke1, mom_o


hmc_separable.launches = 0
#: the launches of the scaled (diagonal-metric) instances, also counted
#: in ``launches``
hmc_separable.scaled_launches = 0
