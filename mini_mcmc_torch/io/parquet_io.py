"""Parquet export (``mini_mcmc_tpu/io/parquet_io.py``).

:func:`save_parquet` is chain-major (``chain, observation, dim_*``);
:func:`save_parquet_tensor` takes an observation-major ``[n_obs,
n_chains, n_dims]`` cube and writes ``observation, chain, dim_*``, the
reference's quirk kept. :class:`ParquetStreamWriter` appends a streamed
run's chunks in that schema.
"""

from __future__ import annotations

from ..native import host_array
from .arrow_io import _cube_to_table

try:
    import pyarrow.parquet as pq

    _HAVE_PYARROW = True
except Exception:  # an installation without pyarrow
    _HAVE_PYARROW = False


def _require_pyarrow():
    if not _HAVE_PYARROW:
        raise RuntimeError("pyarrow is not available; Parquet export disabled")


def save_parquet(data, filename: str) -> None:
    """Save a chain-major ``[n_chains, n_obs, n_dims]`` cube to Parquet."""
    _require_pyarrow()
    arr = host_array(data)
    if arr.ndim != 3:
        raise ValueError(
            f"expected [chains, observations, dims], got {arr.shape}")
    pq.write_table(_cube_to_table(arr), filename)


def save_parquet_tensor(tensor, filename: str) -> None:
    """Save an observation-major ``[n_obs, n_chains, n_dims]`` cube to
    Parquet with ``observation, chain, dim_*`` columns."""
    _require_pyarrow()
    arr = host_array(tensor)
    if arr.ndim != 3:
        raise ValueError(
            f"expected [observations, chains, dims], got {arr.shape}")
    pq.write_table(
        _cube_to_table(arr, leading=("observation", "chain")), filename
    )


class ParquetStreamWriter:
    """Append-as-you-sample Parquet sink for streamed runs.

    Writes :func:`save_parquet_tensor`'s schema chunk by chunk: time-major
    chunks fed in order give a file equal row for row to
    :func:`save_parquet_tensor` of the whole cube, which never exists.
    Use it as the ``on_chunk`` consumer of
    :func:`mini_mcmc_torch.stream_run`::

        with ParquetStreamWriter(path) as w:
            stream_run(sampler, 1_000_000, 10_000, on_chunk=w.append)

    The file is finished on :meth:`close` (or leaving the ``with``); a
    stream that crashes leaves an unreadable file.
    """

    def __init__(self, filename: str, n_chains: int | None = None):
        _require_pyarrow()
        self._filename = filename
        self._writer = None
        self._n_chains = n_chains

    def append(self, chunk, start_observation: int) -> None:
        """Append a time-major ``[k, n_chains, n_dims]`` chunk (array or
        tensor) whose first row is global observation
        ``start_observation`` (``stream_run``'s default ``time_major=True``:
        a chain-major chunk would swap the observation and chain columns).
        The first chunk fixes ``n_chains`` unless the constructor was
        given it, which checks the first chunk's orientation too."""
        arr = host_array(chunk)
        if arr.ndim != 3:
            raise ValueError(
                f"expected [observations, chains, dims], got {arr.shape}"
            )
        if self._n_chains is None:
            self._n_chains = arr.shape[1]
        elif arr.shape[1] != self._n_chains:
            raise ValueError(
                f"chunk has {arr.shape[1]} chains on axis 1, expected "
                f"{self._n_chains} — chunks must be TIME-major [k, C, D] "
                "(stream_run's time_major=True, the default)"
            )
        table = _cube_to_table(arr, leading=("observation", "chain"),
                               major_offset=int(start_observation))
        if self._writer is None:
            self._writer = pq.ParquetWriter(self._filename, table.schema)
        self._writer.write_table(table)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self) -> "ParquetStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
