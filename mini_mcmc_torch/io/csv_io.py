"""CSV export of the ``[chain, observation, dim]`` sample cube
(``mini_mcmc_tpu/io/csv_io.py``).

Header ``chain,observation,dim_0,...``, one row per (chain, observation),
LF line endings. Float cubes go through the native C++ writer
(``native.save_csv_cube``) when it builds; the Python writer is the
fallback of ``native="auto"`` and the writer of integer cubes. Both write
shortest round-trip values, so parsing either file gives the same doubles
(the text may differ in exponent style). For the same numpy cube the
Python writer writes the JAX package's bytes.
"""

from __future__ import annotations

import csv
import subprocess

from ..native import host_array, save_csv_cube


def save_csv(data, filename: str, *, native: bool | str = "auto") -> None:
    """Save a ``[n_chains, n_obs, n_dims]`` array or tensor (on any
    device) as CSV; integer cubes stay integers.

    Args:
        native: ``"auto"`` (default) writes float cubes with the C++
            writer when it builds and with the Python writer otherwise;
            ``True`` requires the C++ writer (raises if it cannot be
            built, and for an integer cube); ``False`` writes with
            Python.
    """
    arr = host_array(data)
    if arr.ndim != 3:
        raise ValueError(
            f"expected [chains, observations, dims], got {arr.shape}")
    if native is True and arr.dtype.kind != "f":
        raise ValueError(
            "native=True requires a float cube (the C++ writer formats "
            f"doubles); got dtype {arr.dtype} — integer cubes always use "
            "the Python writer"
        )
    if native and arr.dtype.kind == "f":
        try:
            save_csv_cube(arr, filename)
            return
        # the library does not build or load here, or its write failed
        except (RuntimeError, OSError, subprocess.SubprocessError):
            if native is True:
                raise
    n_chains, n_obs, n_dims = arr.shape
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(
            ["chain", "observation"] + [f"dim_{i}" for i in range(n_dims)]
        )
        for c in range(n_chains):
            for o in range(n_obs):
                writer.writerow([c, o] + arr[c, o].tolist())


def save_csv_tensor(tensor, filename: str, *,
                    native: bool | str = "auto") -> None:
    """:func:`save_csv` of a tensor: it goes to the host once, as
    ``tensor.detach().cpu().numpy()``; same schema."""
    save_csv(host_array(tensor), filename, native=native)
