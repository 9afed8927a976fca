"""Arrow IPC export (``mini_mcmc_tpu/io/arrow_io.py``).

Columns ``chain`` and ``observation`` (uint32, not nullable) and
``dim_*`` (float64); an empty cube writes an empty batch with the full
schema.
"""

from __future__ import annotations

import numpy as np

from ..native import host_array

try:
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401 — registers pa.ipc

    _HAVE_PYARROW = True
except Exception:  # an installation without pyarrow
    _HAVE_PYARROW = False


def _cube_to_table(arr: np.ndarray, leading=("chain", "observation"),
                   major_offset: int = 0):
    """``[n0, n1, n_dims]`` cube -> the export table: two uint32 index
    columns named ``leading`` (the major axis first) and float64 ``dim_*``
    columns; the one schema of the Arrow and Parquet exporters.
    ``major_offset`` shifts the major index (streamed appends)."""
    n0, n1, n_dims = arr.shape
    major_idx = np.repeat(
        np.arange(major_offset, major_offset + n0, dtype=np.uint32), n1
    )
    minor_idx = np.tile(np.arange(n1, dtype=np.uint32), n0)
    flat = arr.reshape(n0 * n1, n_dims).astype(np.float64)
    fields = [
        pa.field(leading[0], pa.uint32(), nullable=False),
        pa.field(leading[1], pa.uint32(), nullable=False),
    ] + [pa.field(f"dim_{i}", pa.float64(), nullable=False)
         for i in range(n_dims)]
    arrays = [pa.array(major_idx), pa.array(minor_idx)] + [
        pa.array(flat[:, i]) for i in range(n_dims)
    ]
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def save_arrow(data, filename: str) -> None:
    """Save a ``[n_chains, n_obs, n_dims]`` array or tensor as an Arrow
    IPC file."""
    if not _HAVE_PYARROW:
        raise RuntimeError("pyarrow is not available; Arrow export disabled")
    arr = host_array(data)
    if arr.ndim != 3:
        raise ValueError(
            f"expected [chains, observations, dims], got {arr.shape}")
    table = _cube_to_table(arr)
    with pa.OSFile(filename, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
