"""Kernel 7: the separable HMC tier's step (``csrc/hmc_separable.cu``).

Replaces ``mini_mcmc_tpu/ops/pallas/hmc_bigd.py:make_pallas_hmc_separable``
(its production form and the ``mom_input`` debug form) and the accept that
the JAX package leaves to XLA (``mini_mcmc_tpu/ops/hmc.py:_sep_step``).
For a density that is a sum over coordinates, every coordinate follows the
leapfrog on its own: the kernel draws the momentum (paired Box-Muller from
the Philox stream, ``rng.paired_normals``), runs the merged-kick leapfrog
with the coordinate functor's derivative, sums per chain ``logp(pos_prop)``
and the kinetic energies before and after, and accepts.

:func:`hmc_separable_step` is one whole step, ``(positions, logp,
alpha_c)``. Its shape rule: the kernel's D-tiles per chain,
``ceil(ceil(D / 4) / (threads * 2))`` (:func:`sep_tiles`), form one
thread-block cluster when there are at most ``SEP_MAX_CLUSTER`` = 16 of
them (D <= 32,768 at the default 256 threads), and
the accept runs inside that one launch (the fused form, counted in
``hmc_separable_step.launches``). Past 16 tiles the step launches the
trajectory-only form (:func:`hmc_separable`, counted in
``hmc_separable.launches``) and accepts in PyTorch (the two-pass form).
The choice is by shape alone; a cluster launch that the device refuses
raises, as does an instance of which the device holds no cluster
(``cudaOccupancyMaxActiveClusters`` 0, asked once per device, instance and
block size). Both forms draw the same uniform, word x of the Philox counter
``(chain, step, 0, 1)``, so a step's result does not depend on its form
beyond the order of the sums.

:func:`hmc_separable` is the trajectory alone, ``(pos_prop, logp_prop,
ke0, ke1, mom_prop)``: the debug form with a given momentum (its final
momentum returned), the two-pass form's first pass, and the step of a
state whose D is split over ranks (``ops/hmc.py:sep_step``). There ``d0``
places the rows at a D-slice of the state (a multiple of 4): the tables,
the scale and the bijector table are read at the slice's columns, the
momenta drawn as global coordinates ``d0 ..`` (a slice's drawn momenta are
the whole state's columns), and the three sums are the slice's share.

The kernel evaluates the target's coordinate functor
(``Target.cuda_functor``, ``_build.SEP_FUNCTORS``, ``csrc/coord_targets.cuh``;
or a user's, ``Target.cuda_coord_source`` or the one generated from the
tile form, behind ``csrc/user_density.cuh:UserCoord`` in a library of its
own per functor and wrapper bits, any D: ``user_density.sep_lib``, its
derivative by ``mm::Dual<1>`` unless the source gives one)
on its ``[n_tables, D]`` tables, each coordinate's constants prepared once
a launch (for the Gaussian functors the precision, so the leapfrog holds
no division); the twins evaluate the Python ``Target.sep_forms()`` density
on the same tables and take the gradient by autograd, as the TPU kernel
takes it by AD inside each tile. A target whitened by a diagonal metric
(``Target.cuda_scaled``) runs the functor's scaled instance
(``coord_targets.cuh:Scaled``, the scale folded into the precision), the
scale its last table, as the TPU kernel runs the whitened ``sep_form``
with ``n_tables`` one larger. A transformed target
(``Target.cuda_transform``) runs ``coord_targets.cuh:TransformedCoord``,
which reads each coordinate's bijector (code, offset, width) from a
packed ``[3, D]`` table built once per target (:func:`_bij_table`) and,
under a diagonal metric, the scale from the last ``sep_form`` table; the
twins evaluate the transformed ``sep_form`` (one mask table per bijector
group) as the JAX package's.

What bounds it on the H100: bytes at L = 10 (82 MB per step at C = 1,024,
D = 10,000), instructions at L = 40; no ``[C, D]`` momentum or gradient is
stored, and the fused step adds only ``[C]`` values. The wrappers launch
the kernel for CUDA tensors and run their plain twins
(:func:`hmc_separable_step_plain`, :func:`hmc_separable_plain`) for CPU
tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models.transforms import soft_saturation_constants
from . import _build, rng, user_density

#: the tier that runs this kernel, and the dtypes it takes on CUDA
TIER = _build.tier('HMC use_pallas="separable" (Kernel 7)', torch.float32)

_MASK = 0xFFFFFFFF
#: quads of four coordinates per thread (csrc/hmc_separable.cu:kSepGroups)
SEP_GROUPS = 2
#: threads per block of a launch (the kernel takes 32..256)
SEP_THREADS = 256
#: the most D-tiles (blocks) of one chain's cluster, the fused form's limit
SEP_MAX_CLUSTER = 16


def sep_tiles(dim: int, threads: int = SEP_THREADS) -> int:
    """The kernel's D-tiles per chain: ``ceil(ceil(D / 4) / (threads *
    SEP_GROUPS))``."""
    per_tile = threads * SEP_GROUPS
    return ((dim + 3) // 4 + per_tile - 1) // per_tile


def sep_fused(dim: int, threads: int = SEP_THREADS) -> bool:
    """Whether :func:`hmc_separable_step` runs the fused form at this
    shape: at most ``SEP_MAX_CLUSTER`` D-tiles."""
    return sep_tiles(dim, threads) <= SEP_MAX_CLUSTER


def sep_functor(target) -> tuple[int, int]:
    """``(functor id, number of tables)`` of ``target``'s coordinate
    functor (:func:`sep_instance` without its flags)."""
    return sep_instance(target)[:2]


def sep_instance(target) -> tuple[int, int, int]:
    """``(functor id, number of tables, flags)`` of ``target``'s
    coordinate functor, ``flags`` the instance's bits: 1 a diagonal
    metric, 2 a transform. A target whitened once by a diagonal metric
    (``Target.cuda_scaled``) runs the functor's scaled instance, its
    tables the functor's own and the scale. A transformed target
    (``Target.cuda_transform``) runs ``TransformedCoord``, its tables the
    functor's own, one mask per bijector group (read by the twin only) and,
    under a diagonal metric, the scale. A target without a coordinate
    ``cuda_functor`` runs its own functor (``cuda_coord_source``, or the
    one generated from its tile form; ``user_density.sep_lib``), id -1.
    Raises ``ValueError`` for an unknown functor, for a target the kernels
    cannot run (``Target.cuda_unsupported``), past two tables and for any
    other whitened target (a dense metric, or one whitened twice)."""
    if target.cuda_functor is None:
        # a user coordinate functor: cuda_coord_source, or generated from
        # the tile form of the target the wrappers wrap
        _build.supported(target)
        fid = -1
        n_tables = len(user_density.coord_base(target).sep_forms()[1])
        if n_tables > user_density.MAX_COORD_TABLES:
            raise ValueError(
                f"a coordinate functor reads at most "
                f"{user_density.MAX_COORD_TABLES} sep_form tables; the "
                f"target has {n_tables}")
    else:
        fid, n_tables = _build.form_id(target.cuda_functor,
                                       _build.SEP_FUNCTORS, "Target")
        _build.supported(target)
    scaled = int(bool(target.cuda_affine))
    transformed = target.cuda_transform is not None
    n_rows = (len(target.sep_forms()[1]) if scaled or transformed
              else n_tables)
    # a transform adds at least one mask table
    want = n_tables + scaled + transformed
    if ((scaled and not target.cuda_scaled) or n_rows < want
            or (not transformed and n_rows != want)):
        raise ValueError(
            "HMC(use_pallas='separable') runs a whitened target on CUDA "
            "only when one diagonal metric whitens it once (its sep_form "
            f"tables: the functor's {n_tables}, a transform's masks and the "
            f"scale); got {n_rows} tables, cuda_scaled={target.cuda_scaled}")
    return fid, n_rows, scaled | 2 * transformed


@functools.lru_cache(maxsize=16)
def _bij_table(target, device: torch.device, d0: int,
               width: int) -> torch.Tensor:
    """A transformed target's bijector table on ``device`` for the
    coordinates ``[d0, d0 + width)``: its ``[3, width]`` rows (each
    coordinate's code, offset and width, float32), then the six
    soft-saturation constants (``transforms.soft_saturation_constants``)
    and two zeros. Built once per target, device and slice."""
    rows = torch.tensor(target.cuda_transform,
                        dtype=torch.float64).T[:, d0:d0 + width]
    head = torch.tensor(soft_saturation_constants() + (0.0, 0.0),
                        dtype=torch.float64)
    return torch.cat([rows.reshape(-1), head]).to(device, torch.float32)


def _wrapper_ptrs(target, tables, flags: int, d0: int = 0):
    """The bijector table and scale pointers of a launch: ``(bij, scale,
    bij tensor)``, ``None`` where the instance reads none; a transformed
    target's scale is the last row of ``tables``. The bijector table is
    that of the coordinates ``tables`` covers, from ``d0``."""
    if not flags & 2:
        return None, None, None
    bij = _bij_table(target, tables.device, d0, tables.shape[1])
    scale = tables[-1].data_ptr() if flags & 1 else None
    return bij.data_ptr(), scale, bij


def _tile_grad(fn, x, tables):
    """Gradient of the slice density ``fn`` w.r.t. the positions only, by
    autograd (rows and coordinates are independent)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(x, *tables).sum(), x)
    return g


def hmc_separable_plain(target, pos, eps, n_leapfrog: int, seed: int,
                        step: int, tables, mom=None, *, chain0: int = 0,
                        d0: int = 0):
    """Plain PyTorch twin of the trajectory. ``tables`` is the ``[n_tables,
    D]`` tensor of the target's ``sep_forms()`` tables and ``eps`` a
    one-element tensor. ``mom [C, D]`` replaces the Philox momentum (the
    debug form). ``d0`` (a multiple of 4): ``pos`` and ``tables`` hold a
    D-slice starting at coordinate ``d0``, whose momenta are drawn as
    those global coordinates. Returns ``(pos_prop, logp_prop [C], ke0
    [C], ke1 [C], mom_prop)``; ``mom_prop`` is ``None`` without ``mom``."""
    hmc_separable_plain.calls += 1
    fn, _ = target.sep_forms()
    tabs = tuple(tables[i:i + 1] for i in range(tables.shape[0]))
    c, d = pos.shape
    if mom is None:
        mom0 = rng.paired_normals(c, d, step & _MASK, seed, pos.device,
                                  chain0, d0).to(pos.dtype)
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


def accept_uniforms(n_chains: int, step: int, seed: int, device=None,
                    chain0: int = 0) -> torch.Tensor:
    """``[C]`` accept uniforms of a separable step: word x of the Philox
    counter ``(chain0 + c, step, 0, 1)`` (``csrc/philox.cuh``)."""
    chain = torch.arange(chain0, chain0 + n_chains, device=device) & _MASK
    return rng.uniform_at(chain, step & _MASK, 0, seed, sub=1)


def _accept(pos, logp, pos_prop, logp_prop, ke0, ke1, u):
    """``ops/hmc.py:_sep_step``'s accept in the JAX package: ``(positions,
    logp, alpha_c)``, ``alpha_c = exp(min(accept_logp, 0))`` with NaN
    counted as 0. A NaN ``accept_logp`` compares false and is rejected."""
    accept_logp = (-logp + ke0) - (-logp_prop + ke1)
    alpha_c = torch.nan_to_num(torch.exp(torch.clamp(accept_logp, max=0.0)),
                               nan=0.0)
    accept = accept_logp >= torch.log(u)
    return (torch.where(accept[:, None], pos_prop, pos),
            torch.where(accept, logp_prop, logp), alpha_c)


def hmc_separable_step_plain(target, pos, logp, eps, n_leapfrog: int,
                             seed: int, step: int, tables, *, mom=None,
                             u=None, chain0: int = 0):
    """Plain PyTorch twin of the fused step: :func:`hmc_separable_plain`,
    then the accept with ``u`` from :func:`accept_uniforms` unless ``u
    [C]`` is given (``mom [C, D]`` replaces the momentum likewise).
    Returns ``(positions, logp, alpha_c)``."""
    hmc_separable_step_plain.calls += 1
    pos_prop, logp_prop, ke0, ke1, _ = hmc_separable_plain(
        target, pos, eps, n_leapfrog, seed, step, tables, mom, chain0=chain0)
    if u is None:
        u = accept_uniforms(pos.shape[0], step, seed, pos.device, chain0)
    return _accept(pos, logp, pos_prop, logp_prop, ke0, ke1, u)


hmc_separable_step_plain.calls = 0


def _check(target, pos, eps, tables, mom, threads: int, d0: int = 0):
    """The kernel's contract on its inputs; returns ``(functor id,
    flags)``."""
    fid, n_tables, flags = sep_instance(target)
    if d0 < 0 or d0 % 4:
        raise ValueError(f"a D-slice starts at a multiple of 4 (Kernel 7's "
                         f"coordinate quads); got d0={d0}")
    if pos.dim() != 2 or pos.dtype != torch.float32:
        raise ValueError("the separable kernel takes float32 [C, D] "
                         f"positions; got {pos.dtype} {tuple(pos.shape)}")
    d = pos.shape[1]
    if tables.shape != (n_tables, d) or tables.dtype != torch.float32:
        raise ValueError(
            f"coordinate functor {target.cuda_functor or 'Coord'!r} reads "
            f"{n_tables} "
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
    return fid, flags


def _sep_lib(target, fid: int, flags: int, dim: int, device) -> tuple:
    """``(library, params pointer)`` of a launch: the built-in library and
    the functor's params past the wrappers' tables, or a user functor's
    own library (``user_density.sep_lib``, built if need be)."""
    if fid >= 0:
        return _build.lib(), _build.params_ptr(target, device, dim)
    return user_density.sep_lib(target, flags, dim, device)


def _vec(d: int, *tensors) -> int:
    """The float4 path needs D a multiple of 4 and every row 16-byte
    aligned, each table row too (row 1 starts D floats after row 0)."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                                  if t is not None))


def _trajectory(target, pos, eps, n_leapfrog, seed, step, tables, mom,
                chain0, threads, d0=0, n_dim=None):
    """Launch the trajectory-only form: ``(pos_prop, parts [3, C, tiles],
    mom_prop)``; ``d0`` and ``n_dim`` as :func:`hmc_separable`'s."""
    fid, flags = _check(target, pos, eps, tables, mom, threads, d0)
    c, d = pos.shape
    pos_o = torch.empty_like(pos)
    mom_o = None if mom is None else torch.empty_like(pos)
    parts = pos.new_empty((3, c, sep_tiles(d, threads)))
    seed_lo, seed_hi = rng.seed_words(seed)
    bij, scale, bij_t = _wrapper_ptrs(target, tables, flags, d0)
    lib, params = _sep_lib(target, fid, flags, n_dim or d0 + d, pos.device)
    hmc_separable.launches += 1
    hmc_separable.scaled_launches += flags & 1
    hmc_separable.transformed_launches += flags >> 1
    hmc_separable.user_launches += fid < 0
    _build.check(lib.mm_hmc_separable(
        pos.data_ptr(), None if mom is None else mom.data_ptr(),
        eps.data_ptr(), params,
        tables.data_ptr() if tables.shape[0] else None, bij, scale, c, d,
        n_leapfrog, fid, flags, threads,
        _vec(d, pos, pos_o, *tables, mom, mom_o, bij_t), chain0 & _MASK,
        d0, seed_lo, seed_hi, step & _MASK, pos_o.data_ptr(),
        None if mom_o is None else mom_o.data_ptr(), parts.data_ptr(),
        _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, parts, mom_o


def hmc_separable(target, pos, eps, n_leapfrog: int, seed: int, step: int,
                  tables, mom=None, *, chain0: int = 0, d0: int = 0,
                  n_dim: int | None = None, threads: int = SEP_THREADS):
    """One trajectory per chain of ``pos [C, D]`` at step size ``eps`` (a
    one-element tensor on the positions' device), drawing the momentum at
    ``(seed, chain0 + c, step)`` unless ``mom`` is given. Returns
    ``(pos_prop, logp_prop, ke0, ke1, mom_prop)`` as
    :func:`hmc_separable_plain`. ``d0`` (a multiple of 4; else
    ``ValueError``) places ``pos`` and ``tables`` at a D-slice of a state
    of ``n_dim`` coordinates (default ``d0 + D``; the functor's params
    are read at it), its momenta drawn as global coordinates ``d0 ..``
    and its sums the slice's share. ``threads`` sets the launch's block
    size and so its D-tiles; the results do not depend on it beyond the
    order of the sums."""
    if not pos.is_cuda:
        return hmc_separable_plain(target, pos, eps, n_leapfrog, seed, step,
                                   tables, mom, chain0=chain0, d0=d0)
    pos_o, parts, mom_o = _trajectory(target, pos, eps, n_leapfrog, seed,
                                      step, tables, mom, chain0, threads,
                                      d0, n_dim)
    logp, ke0, ke1 = parts.sum(dim=2)
    return pos_o, logp, ke0, ke1, mom_o


hmc_separable.launches = 0
#: the launches of the scaled (diagonal-metric) instances, also counted
#: in ``launches``
hmc_separable.scaled_launches = 0
#: the launches of the transformed instances, also counted in ``launches``
hmc_separable.transformed_launches = 0
#: the launches of a user coordinate functor's instances, also counted in
#: ``launches``
hmc_separable.user_launches = 0


@functools.lru_cache(maxsize=None)
def _clusters(device: torch.device, lib, fid: int, flags: int, threads: int,
              n_tiles: int) -> int:
    """The fused form's clusters that ``device`` holds at once for this
    instance (of library ``lib``) and block size
    (``cudaOccupancyMaxActiveClusters``); raises when it holds none."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib.mm_hmc_separable_clusters(
            fid, flags, threads, n_tiles, ctypes.byref(out)), lib)
    if out.value < 1:
        raise RuntimeError(
            f"the device holds no cluster of {n_tiles} blocks of {threads} "
            f"threads of the separable kernel (functor {fid}, flags "
            f"{flags})")
    return out.value


def hmc_separable_step(target, pos, logp, eps, n_leapfrog: int, seed: int,
                       step: int, tables, *, mom=None, u=None,
                       chain0: int = 0, d0: int = 0,
                       n_dim: int | None = None, reduce=None,
                       threads: int = SEP_THREADS):
    """One whole separable HMC step of every chain of ``pos [C, D]`` with
    cached density ``logp [C]`` at step size ``eps`` (a one-element tensor
    on the positions' device). Returns ``(positions, logp, alpha_c)``,
    ``alpha_c [C]`` each chain's acceptance probability (NaN counted as
    0), as :func:`hmc_separable_step_plain`.

    ``mom [C, D]`` and ``u [C]`` replace the Philox momentum and accept
    uniform (parity tests). ``threads`` sets the launch's block size and
    so its D-tiles; results do not depend on it beyond the order of the
    sums. The form follows the shape rule of the module's docstring
    (:func:`sep_fused`). ``reduce`` makes ``pos`` and ``tables`` a D-slice
    from ``d0`` of a state of ``n_dim`` coordinates (as
    :func:`hmc_separable`): the step takes the two-pass form on either
    device, and ``reduce`` maps the slice's ``[3, C]`` sums (logp, the
    two kinetic energies) to the whole state's before the accept."""
    if reduce is None and not pos.is_cuda:
        return hmc_separable_step_plain(target, pos, logp, eps, n_leapfrog,
                                        seed, step, tables, mom=mom, u=u,
                                        chain0=chain0)
    c, d = pos.shape
    for name, t in (("logp", logp), ("u", u)):
        if t is not None and pos.is_cuda and (
                t.shape != (c,) or t.dtype != torch.float32
                or t.device != pos.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [C] "
                             "tensor on the positions' device")
    n_tiles = sep_tiles(d, threads)
    if reduce is not None or n_tiles > SEP_MAX_CLUSTER:  # the two-pass form
        pos_prop, *sums, _ = hmc_separable(
            target, pos, eps, n_leapfrog, seed, step, tables, mom,
            chain0=chain0, d0=d0, n_dim=n_dim, threads=threads)
        logp_prop, ke0, ke1 = (sums if reduce is None
                               else reduce(torch.stack(sums)))
        if u is None:
            u = accept_uniforms(c, step, seed, pos.device, chain0)
        return _accept(pos, logp, pos_prop, logp_prop, ke0, ke1, u)
    fid, flags = _check(target, pos, eps, tables, mom, threads)
    lib, params = _sep_lib(target, fid, flags, d, pos.device)
    _clusters(pos.device, lib, fid, flags, threads, n_tiles)
    pos_o = torch.empty_like(pos)
    logp_o = torch.empty_like(logp)
    alpha_o = torch.empty_like(logp)
    seed_lo, seed_hi = rng.seed_words(seed)
    bij, scale, bij_t = _wrapper_ptrs(target, tables, flags)
    hmc_separable_step.launches += 1
    hmc_separable_step.scaled_launches += flags & 1
    hmc_separable_step.transformed_launches += flags >> 1
    hmc_separable_step.user_launches += fid < 0
    _build.check(lib.mm_hmc_separable_step(
        pos.data_ptr(), None if mom is None else mom.data_ptr(),
        None if u is None else u.data_ptr(), logp.data_ptr(),
        eps.data_ptr(), params,
        tables.data_ptr() if tables.shape[0] else None, bij, scale, c, d,
        n_leapfrog, fid, flags, threads,
        _vec(d, pos, pos_o, *tables, mom, bij_t), chain0 & _MASK, seed_lo,
        seed_hi,
        step & _MASK, pos_o.data_ptr(), logp_o.data_ptr(),
        alpha_o.data_ptr(), _build.stream_ptr(pos.device),
    ), lib)
    return pos_o, logp_o, alpha_o


#: launches of the fused form (the two-pass form counts in
#: ``hmc_separable.launches``)
hmc_separable_step.launches = 0
#: the fused launches of the scaled (diagonal-metric) instances, also
#: counted in ``launches``
hmc_separable_step.scaled_launches = 0
#: the fused launches of the transformed instances, also counted in
#: ``launches``
hmc_separable_step.transformed_launches = 0
#: the fused launches of a user coordinate functor's instances, also
#: counted in ``launches``
hmc_separable_step.user_launches = 0
