"""Build and load the hand-written CUDA kernels.

The sources under ``mini_mcmc_torch/csrc/`` are compiled with ``nvcc`` at
first CUDA use, one ``nvcc`` per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of the sources and flags, so
an edited source builds anew and an unchanged one is reused from
``build/mini_mcmc_torch/`` (listed in ``.gitignore``). Nothing here runs at
import: CPU-only installs import every module without ``nvcc``.

Every kernel takes a form by one of two routes: a built-in functor
(``Target.cuda_functor``, ``Proposal.cuda_functor``,
``Conditional.cuda_functor``: ``csrc/targets.cuh``, ``proposals.cuh``,
``conditionals.cuh``, ``coord_targets.cuh``), through this library; or the
user's C++ (``cuda_source``, ``Target.cuda_coord_source``, or a density or
coordinate functor generated from its PyTorch form), through a library of
its own (``user_density.py``): Kernels 1-4 by :func:`kernel_lib`, 5 and 8
by ``mh_full.mh_lib`` and ``pt_full.pt_lib``, 6 by
``gibbs_full.gibbs_lib``, 7 by ``hmc_sep._sep_lib``.

``-use_fast_math`` is deliberately absent: ``__logf``/``__cosf`` would move
the Box-Muller tails, and an approximate ``logf(u)`` changes which chains
are accepted.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mini_mcmc_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Target.cuda_functor names -> the ids of csrc/targets.cuh
FUNCTORS = {"rosenbrock_nd": 0, "gaussian2d": 1, "poisson": 2,
            "gaussian_mixture_1d": 3, "neal_funnel": 4}
#: Target.cuda_functor names of the separable HMC tier's coordinate
#: functors -> (id in csrc/coord_targets.cuh, number of [1, D] tables)
SEP_FUNCTORS = {"standard_normal": (0, 0), "isotropic_gaussian": (1, 0),
                "sigma_table_normal": (2, 1)}
#: (target, D, transformed) instantiated by csrc/pt_multistep.cu, each for
#: ladders of up to PT_MAX_TEMPS rungs; transformed: the functor inside
#: targets.cuh:Transformed (a transform=)
PT_INSTANCES = tuple((t, d, tf) for t, d in (("gaussian2d", 2),
                                              ("gaussian_mixture_1d", 1))
                     for tf in (False, True))
PT_MAX_TEMPS = 16
#: Proposal.cuda_functor names -> the ids of csrc/proposals.cuh
PROPOSALS = {"isotropic_gaussian": 0, "random_walk_int": 1}
#: Conditional.cuda_functor names -> the ids of csrc/conditionals.cuh
CONDITIONALS = {"gaussian_mixture": 0}
#: dims instantiated by MM_DISPATCH in csrc/hmc_common.cuh (Rosenbrock and
#: the funnel at all three, the Gaussian at 2), each plain, transformed,
#: whitened and whitened over transformed
KERNEL_DIMS = (2, 3, 4)
#: the largest D of the user instances of Kernels 1-4
#: (``user_density.MAX_DIM``), the JAX package's ``_DENSE_DC_MAX_DIM``
WRAPPED_MAX_DIM = 16
#: above this D a diagonal metric enters Kernels 1-4 as D scales
#: (``csrc/targets.cuh:WhitenedDiag``), not a triangle of L
DIAG_TRIANGLE_MAX_DIM = max(KERNEL_DIMS)
#: the head of a transformed target's bijector table: (a, s, 1 / s) of
#: each soft saturation (models/transforms.py:soft_saturation_constants)
TRANSFORM_HEAD = 6
#: (target, proposal, state dtype, D, transformed) instantiated by
#: csrc/mh_multistep.cu; transformed: the functor inside
#: targets.cuh:Transformed (a transform=), float32 states only
MH_INSTANCES = tuple(
    (t, "isotropic_gaussian", torch.float32, d, tf)
    for t, d in (("gaussian2d", 2), ("rosenbrock_nd", 2),
                 ("rosenbrock_nd", 3))
    for tf in (False, True)) + (
    ("poisson", "random_walk_int", torch.int32, 1, False),)
#: (conditional, D) instantiated by csrc/gibbs_multistep.cu
GIBBS_INSTANCES = (("gaussian_mixture", 2),)
#: state dtypes -> csrc/mh_multistep.cu:StateType
STATE_TYPES = {torch.float32: 0, torch.int32: 1}
#: the state dtypes each fused tier takes on CUDA (the dtypes its JAX
#: kernel runs), one entry a kernel module, its ``TIER`` (:func:`tier`):
#: float32 everywhere; float64 in Kernel 1 alone (the trajectory of
#: ``use_pallas=True`` HMC and MALA), the one JAX kernel that runs float64
#: under ``jax_enable_x64``; int32 in Kernel 5 (MH)
TIER_DTYPES: dict = {}


def tier(name: str, *dtypes) -> str:
    """Enter the CUDA tier ``name`` in :data:`TIER_DTYPES`, taking states
    of ``dtypes``; returns ``name``, the ``TIER`` of the kernel module
    that runs it, which its callers pass to :func:`check_tier_dtype`."""
    TIER_DTYPES[name] = dtypes
    return name


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_I32 = ctypes.c_int32
_LL = ctypes.c_longlong


def form_id(name: str | None, table: dict, kind: str) -> int:
    """The id in ``table`` of the built-in CUDA form ``name`` of a
    ``kind`` (Target, Proposal, Conditional); raises for ``None`` (a
    Python-only form, which the kernels cannot run) or an unknown name."""
    if name is None:
        own = {"Target": "Target.cuda_source (Kernels 1-5 and 8; without "
                         "one, C++ generated from the batch form) or "
                         "Target.cuda_coord_source (the separable kernel)",
               "Proposal": "Proposal.cuda_source with propose_words",
               "Conditional": "Conditional.cuda_source with sample_words"}
        raise ValueError(
            f"no built-in CUDA form named: {kind}.cuda_functor is None "
            f"(built in: {sorted(table)}). A user form reaches the kernels "
            f"as {own.get(kind, kind + '.cuda_source')}; or use "
            "use_pallas=False."
        )
    if name not in table:
        raise ValueError(f"unknown {kind}.cuda_functor {name!r}; built in: "
                         f"{sorted(table)}")
    return table[name]


def supported(target) -> None:
    """Raise for a target whose wrappers the kernels cannot run
    (``Target.cuda_unsupported``: a custom bijector, or a transform around
    a whitened or transformed target)."""
    if target.cuda_unsupported is not None:
        raise ValueError(
            f"use_pallas cannot run this target on CUDA: "
            f"{target.cuda_unsupported}. Use use_pallas=False.")


def functor_id(target) -> int:
    """The kernel id of ``target``'s built-in CUDA density; raises for a
    target that has none (the kernels cannot run a Python density) or
    whose wrappers they cannot run."""
    fid = form_id(target.cuda_functor, FUNCTORS, "Target")
    supported(target)
    return fid


def instance_flags(target) -> int:
    """The ``affine`` argument of Kernels 1-4: bit 0 a whitened target
    (``mm::Whitened``), bit 1 a transformed one (``mm::Transformed``);
    both run ``Whitened<Transformed<T, D>, D>`` (``MM_AFFINE``); bit 2,
    with bit 0, a diagonal metric given as D scales (``mm::WhitenedDiag``,
    ``Target.cuda_diag``; user instances only)."""
    supported(target)
    return (int(target.cuda_affine)
            | (2 * (target.cuda_transform is not None))
            | (4 * bool(target.cuda_affine and target.cuda_diag)))


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_tier_dtype(tier: str, dtype) -> None:
    """Raise unless the CUDA tier ``tier`` (a key of ``TIER_DTYPES``)
    takes states of ``dtype``, naming what each tier takes on the card."""
    if dtype in TIER_DTYPES[tier]:
        return
    takes = "; ".join(
        f"{t}: {', '.join(dtype_name(d) for d in dts)}"
        for t, dts in sorted(TIER_DTYPES.items()))
    raise ValueError(
        f"{tier} does not take {dtype_name(dtype)} states on CUDA. On the "
        f"card each tier takes: {takes}. Use use_pallas=False (any dtype) "
        "or a tier that takes this dtype.")


def kernel_lib(target, dim: int, device, dtype=torch.float32) -> tuple:
    """``(library, target id, params pointer)`` of ``target`` at ``dim``
    for Kernels 1-4: the built-in library and its functor's id for a
    ``cuda_functor``, else the target's own library
    (``user_density.kernel_lib``: its ``cuda_source``, or the C++
    generated from its batch form, compiled at ``dim``). ``dtype``
    float64: Kernel 1's float64 instances (their library and params at
    double). Raises for a target neither route runs."""
    if target.cuda_functor is not None:
        tid = functor_id(target)
        if dim not in KERNEL_DIMS:
            raise ValueError(f"the CUDA kernels are built for D in "
                             f"{KERNEL_DIMS}; got D={dim}")
        return lib(), tid, params_ptr(target, device, dtype=dtype, dim=dim)
    supported(target)
    if dim not in kernel_dims(target):
        raise ValueError(f"user densities run in Kernels 1-4 at D <= "
                         f"{WRAPPED_MAX_DIM}; got D={dim}")
    from . import user_density

    return user_density.kernel_lib(target, dim, device, dtype)


def unwhitened(target, what: str) -> bool:
    """Whether ``target`` is transformed (the MH and tempering kernels'
    ``transformed`` argument: ``mm::Transformed``); raises for a whitened
    target, which they have no instance for (the JAX MH and tempering take
    no ``metric=``), and for wrappers no kernel runs."""
    supported(target)
    if target.cuda_affine:
        raise ValueError(
            f"{what} with a whitened (metric=) target does not run on "
            "CUDA: MH and tempering take no metric; only Kernels 1-4 and "
            "the separable kernel run the whitened wrapper")
    return target.cuda_transform is not None


def proposal_id(proposal) -> int:
    """The MH kernel's id of ``proposal``'s built-in CUDA form; raises for
    a proposal that has none."""
    return form_id(proposal.cuda_functor, PROPOSALS, "Proposal")


def conditional_id(conditional) -> int:
    """The Gibbs kernel's id of ``conditional``'s built-in CUDA form;
    raises for a conditional that has none."""
    return form_id(conditional.cuda_functor, CONDITIONALS, "Conditional")


def hist_args(hist, k: int, c: int, d: int, dtype, device) -> tuple:
    """``(pointer, step stride, chain stride)`` of a ``[K, C, D]`` history
    view for a kernel's launch, ``(None, 0, 0)`` for no history; raises
    unless ``hist`` has that shape, ``dtype``, lies on ``device`` and has
    a unit D stride (any other strides: time- or chain-major cubes)."""
    if hist is None:
        return None, 0, 0
    if (hist.shape != (k, c, d) or hist.dtype != dtype
            or hist.device != device or hist.stride(2) != 1):
        raise ValueError(
            f"hist must be a {str(dtype).replace('torch.', '')} [{k}, {c}, "
            f"{d}] view on {device} with unit D stride; got {hist.dtype} "
            f"{tuple(hist.shape)} strides {hist.stride()}")
    return hist.data_ptr(), hist.stride(0), hist.stride(1)


@functools.lru_cache(maxsize=64)
def _params_on(params: tuple, device: torch.device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(params, dtype=dtype, device=device)


def kernel_dims(target) -> tuple:
    """The D at which Kernels 1-4 run ``target``: ``KERNEL_DIMS`` for a
    built-in functor, 1 to ``WRAPPED_MAX_DIM`` for a user density."""
    if target.cuda_functor is not None:
        return KERNEL_DIMS
    return tuple(range(1, WRAPPED_MAX_DIM + 1))


def wrapper_floats(target, dim: int) -> int:
    """The floats of ``target.cuda_params`` ahead of its functor's own at
    ``dim``: a whitened target's triangle of ``L`` (or D scales under
    ``cuda_diag``) and a transformed one's bijector table, which it
    carries only where Kernels 1-4 run it (:func:`kernel_dims`)."""
    n = 0
    if dim <= max(kernel_dims(target)):
        if target.cuda_affine:
            n += dim if target.cuda_diag else dim * (dim + 1) // 2
        if target.cuda_transform is not None:
            n += TRANSFORM_HEAD + 3 * dim
    return n


def kernel_params(target, dim: int, dtype=torch.float32) -> tuple:
    """``target.cuda_params`` as Kernels 1-4 read them at ``dim``: at
    float64 a transformed target's soft-saturation constants are the
    float64 squashes' (``transforms.soft_saturation_constants``), as the
    twin's ``y.dtype`` picks them; every other float is the target's."""
    params = tuple(target.cuda_params)
    if (dtype == torch.float64 and target.cuda_transform is not None
            and dim <= max(kernel_dims(target))):
        from ...models.transforms import soft_saturation_constants

        off = 0
        if target.cuda_affine:
            off = dim if target.cuda_diag else dim * (dim + 1) // 2
        params = (params[:off] + soft_saturation_constants(torch.float64)
                  + params[off + TRANSFORM_HEAD:])
    return params


def params_ptr(target, device, functor_dim: int | None = None, *,
               dtype=torch.float32, dim: int | None = None) -> int | None:
    """Device pointer to ``target.cuda_params`` as ``dtype`` (float32,
    or float64 for Kernel 1's float64 instances, :func:`kernel_params` at
    ``dim``; copied to the device once per target, device and dtype), or
    ``None`` for a functor without coefficients. ``functor_dim``: read
    them for a kernel that runs the functor alone at that D, past the
    wrappers' tables (:func:`wrapper_floats`)."""
    params = tuple(target.cuda_params)
    if dim is not None:
        params = kernel_params(target, dim, dtype)
    if functor_dim is not None:
        params = params[wrapper_floats(target, functor_dim):]
    if not params:
        return None
    return _params_on(params, torch.device(device), dtype).data_ptr()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def compile_libraries(jobs) -> None:
    """Compile ``jobs``, ``(sources, library path)`` pairs, each source in
    its own ``nvcc`` process (``csrc/`` on the include path) and every
    process of every job started together, then link each job's objects
    into its library. A job's ``ptxas -v`` reports go to a ``.log`` beside
    its library, whose first line gives the seconds from the start to its
    link. Raises ``RuntimeError`` with nvcc's output if any job fails; the
    others are linked all the same."""
    if not jobs:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    started = []
    for srcs, so in jobs:
        tag = f"{so.stem}.{os.getpid()}"
        procs = []
        for src in srcs:
            obj = BUILD_DIR / f".{src.stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                   str(obj), str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        started.append((so, tag, procs))
    failed = []
    for so, tag, procs in started:
        log, bad = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                bad.append(f"{src.name} (code {proc.returncode}):\n"
                           f"{out[-4000:]}")
        tmp = BUILD_DIR / f".{tag}.so"
        if not bad:
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj, _ in procs)],
                capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                bad.append(f"link (code {link.returncode}):\n{link.stderr}")
        for _, obj, _ in procs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        so.with_suffix(".log").write_text(
            f"build seconds {seconds:.3f}\n" + "\n".join(log))
        if bad:
            failed.append(f"{so.name}:\n" + "\n".join(bad))
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build(also=()) -> Path:
    """Compile ``csrc/*.cu`` into ``build/mini_mcmc_torch/`` unless a
    library of the same sources and flags is already there; returns its
    path. Each source compiles in its own ``nvcc`` process, all at once,
    together with the jobs of ``also`` (``user_density.jobs``: the
    libraries of user densities); the ``ptxas -v`` reports go to a
    ``.log`` beside the library."""
    files = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libmm_kernels_{h.hexdigest()[:16]}.so"
    jobs = list(also)
    if not so.exists():
        jobs.append(([p for p in files if p.suffix == ".cu"], so))
    compile_libraries(jobs)
    return so


#: the C entries of Kernels 1-4, whose per-density libraries export them too
KERNEL_SIGS = {
    "mm_leapfrog_f32": [_P] * 5 + [_I] * 6 + [_P] * 5,
    "mm_hmc_multistep_f32": [_P] * 5 + [_I] * 6 + [_U] * 4
    + [_P] * 4 + [_LL, _LL, _P],
    "mm_nuts_subtree_f32": [_P] * 9 + [_I, _I, _I32, _I32, _U] + [_I] * 4
    + [_P] * 11 + [_I, _P, _P],
    "mm_nuts_step_f32": [_P] * 3 + [_I, _I] + [_U] * 4 + [_I] * 4
    + [_P, _I] + [_P] * 6 + [_I, _P, _P],
}


def bind(handle: ctypes.CDLL, sigs: dict = KERNEL_SIGS) -> ctypes.CDLL:
    """Set the argument and result types of ``sigs``' entries and of
    ``mm_error_string`` on a loaded library."""
    for name, argtypes in sigs.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = _I
    handle.mm_error_string.argtypes = [_I]
    handle.mm_error_string.restype = ctypes.c_char_p
    return handle


#: Kernel 1's float64 entry, which a float64 density library exports alone
F64_SIGS = {"mm_leapfrog_f64": KERNEL_SIGS["mm_leapfrog_f32"]}

#: the C entries of Kernels 0 and 5-8, whose per-form libraries
#: (``user_density.py``) export those of their kernel too
ENTRY_SIGS = {
    "mm_philox_fill": [_P, _I, _U, _U, _U, _U, _P],
    "mm_mh_multistep": [_P] * 4 + [_I] * 7 + [_U] * 4 + [_P] * 3
    + [_LL, _LL, _P],
    "mm_gibbs_multistep": [_P] * 2 + [_I] * 4 + [_U] * 4 + [_P] * 2
    + [_LL, _LL, _P],
    "mm_hmc_separable": [_P] * 7 + [_I] * 7 + [_U] * 5 + [_P] * 4,
    "mm_hmc_separable_step": [_P] * 9 + [_I] * 7 + [_U] * 4 + [_P] * 4,
    "mm_hmc_separable_clusters": [_I] * 4 + [_P],
    "mm_pt_multistep": [_P] * 5 + [_I] * 8 + [_U] * 4 + [_P] * 4
    + [_LL, _LL, _P],
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return bind(ctypes.CDLL(str(build())),
                dict(KERNEL_SIGS, **F64_SIGS, **ENTRY_SIGS))


def check(code: int, handle: ctypes.CDLL | None = None) -> None:
    """Raise if a kernel's C entry (of ``handle``, the built-in library by
    default) returned a CUDA error code."""
    if code != 0:
        msg = (handle or lib()).mm_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed ({code}): {msg}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream
