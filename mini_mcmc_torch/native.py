"""ctypes binding of the native C++ library ``native/mcmc_native.cpp``
(counterpart of ``mini_mcmc_tpu/native.py``).

The library holds the fast CSV writer of :func:`~mini_mcmc_torch.io.
save_csv` and an implementation of split R-hat, ESS and the rank
diagnostics independent of PyTorch, which the tests hold
``stats``/``diagnostics`` against. It is compiled at first use with
``g++`` and the flags of ``native/Makefile`` into
``build/mini_mcmc_torch/`` (listed in ``.gitignore``), under a name that
hashes the source, the flags, the compiler's version and its resolved
target (``-march=native`` builds for the host's CPU, so a library built on
another machine is not reused). Nothing is written into ``native/`` and
nothing builds at import. Every entry point takes a numpy array or a
tensor on any device; the result is numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mcmc_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "mini_mcmc_torch"
#: ``native/Makefile``'s CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17")
OPENMP_FLAG = "-fopenmp"

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    return path


def _build(flags: tuple) -> Path:
    """The library compiled with ``flags`` (reused when present)."""
    cxx = _cxx()
    h = hashlib.sha256(" ".join((cxx, *flags)).encode())
    # the compiler's version and the options -march=native resolves to on
    # this host
    for args in (["--version"], [*CXX_FLAGS[:2], "-Q", "--help=target"]):
        h.update(subprocess.run([cxx, *args], capture_output=True,
                                text=True, check=True).stdout.encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libmcmc_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{so.name}.", dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run([cxx, *flags, "-o", tmp, str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed (code {out.returncode}) on "
                           f"{SOURCE.name} with {' '.join(flags)}:\n"
                           f"{out.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def build() -> tuple[Path, tuple]:
    """Compile ``native/mcmc_native.cpp`` unless a library of the same
    source, flags, compiler and target is already in
    ``build/mini_mcmc_torch/``; returns its path and the flags it was
    built with. The compiler writes to a name of its own and the result
    is renamed into place, so processes that build at once do not read a
    half-written library.

    A toolchain without OpenMP's runtime (``libgomp``) refuses
    ``-fopenmp``; the library is then built without it, and the source's
    ``#pragma omp`` loops (the diagnostics' loop over parameters; not the
    CSV writer) run on one thread with the same results. The returned
    flags say which build it is."""
    try:
        return _build(CXX_FLAGS), CXX_FLAGS
    except RuntimeError as e:
        if "gomp" not in str(e):
            raise
    flags = tuple(f for f in CXX_FLAGS if f != OPENMP_FLAG)
    return _build(flags), flags


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library (built on first call); its ``cxx_flags`` are
    the flags it was built with."""
    so, flags = build()
    lib = ctypes.CDLL(str(so))
    lib.cxx_flags = flags
    lib.mcmc_autocov_bf.argtypes = [_F32P, _I64, _I64, _F32P]
    lib.mcmc_geyer_tau.argtypes = [_F32P, _I64, _I64, _F32P]
    lib.mcmc_split_rhat_ess.argtypes = [_F32P, _I64, _I64, _I64, _F32P,
                                        _F32P]
    lib.mcmc_rank_normalized_diag.argtypes = [_F32P, _I64, _I64, _I64,
                                              _F32P, _F32P, _F32P, _F32P]
    lib.mcmc_save_csv_f64.argtypes = [_F64P, _I64, _I64, _I64,
                                      ctypes.c_char_p]
    lib.mcmc_save_csv_f64.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except Exception:
        return False


def host_array(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor on any device goes to the host
    once."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(host_array(a), dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def autocov_bf(data) -> np.ndarray:
    """Brute-force autocovariance of each column: ``[n, d] -> [n, d]``."""
    lib = load()
    data = _f32(data)
    n, d = data.shape
    out = np.empty((n, d), np.float32)
    lib.mcmc_autocov_bf(_ptr(data), n, d, _ptr(out))
    return out


def geyer_tau(rho) -> np.ndarray:
    """Geyer's initial monotone sum of pairs per column: ``[n, p] ->
    [p]``."""
    lib = load()
    rho = _f32(rho)
    n, p = rho.shape
    out = np.empty((p,), np.float32)
    lib.mcmc_geyer_tau(_ptr(rho), n, p, _ptr(out))
    return out


def split_rhat_ess(sample) -> Tuple[np.ndarray, np.ndarray]:
    """Split-chain R-hat and ESS: ``[c, n, p] -> (rhat [p], ess [p])``."""
    lib = load()
    sample = _f32(sample)
    c, n, p = sample.shape
    rhat = np.empty((p,), np.float32)
    ess = np.empty((p,), np.float32)
    lib.mcmc_split_rhat_ess(_ptr(sample), c, n, p, _ptr(rhat), _ptr(ess))
    return rhat, ess


def rank_normalized_diag(sample) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """Rank-normalized diagnostics (Vehtari et al. 2021): ``[c, n, p] ->
    (rhat_bulk, rhat_folded, ess_bulk, ess_tail)``, each ``[p]``."""
    lib = load()
    sample = _f32(sample)
    c, n, p = sample.shape
    outs = [np.empty((p,), np.float32) for _ in range(4)]
    lib.mcmc_rank_normalized_diag(_ptr(sample), c, n, p,
                                  *[_ptr(o) for o in outs])
    return tuple(outs)


def save_csv_cube(cube, path: str) -> None:
    """CSV of a ``[c, n, d]`` float cube in the reference's schema, values
    in shortest round-trip form (``std::to_chars``): parsing the text
    gives back the exact double, as for the Python writer's ``repr``."""
    lib = load()
    cube = np.ascontiguousarray(host_array(cube), dtype=np.float64)
    if cube.ndim != 3:
        raise ValueError(f"expected [c, n, d], got shape {cube.shape}")
    c, n, d = cube.shape
    rc = lib.mcmc_save_csv_f64(cube.ctypes.data_as(_F64P), c, n, d,
                               os.fsencode(path))
    if rc != 0:
        raise OSError(f"native CSV writer failed (code {rc}) for {path}")
