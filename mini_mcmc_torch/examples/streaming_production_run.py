"""Production-scale sampling that never holds the full cube in memory.

Counterpart of ``examples/streaming_production_run.py``: ``stream_run``
delivers fixed-size time-major chunks straight into a
:class:`~mini_mcmc_torch.io.ParquetStreamWriter` while the streaming
tracker carries whole-run acceptance and live R-hat; the Parquet file is
row for row the one-shot export of the (never-materialized) full cube.

Here: 512 chains x 4,096 draws of a correlated Gaussian streamed in 16
chunks — peak host memory is one [256, 512, 2] chunk (~1 MB) instead of
the 16 MB cube. Needs ``pyarrow``.
"""

import os
import tempfile

import numpy as np

from .. import MetropolisHastings, init_with_seed, stream_run
from ..io import ParquetStreamWriter
from ..models import gaussian2d, isotropic_gaussian_proposal

N_CHAINS, N_TOTAL, CHUNK = 512, 4096, 256


def main(device="cuda"):
    import pyarrow.parquet as pq

    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    mh = MetropolisHastings(
        target, isotropic_gaussian_proposal(1.5),
        init_with_seed(N_CHAINS, 2, seed=0, device=device), device=device,
    ).seed(42)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "draws.parquet")
        with ParquetStreamWriter(path) as writer:
            result = stream_run(
                mh, N_TOTAL, CHUNK, on_chunk=writer.append, n_discard=512
            )
        print(result)

        table = pq.read_table(path)
        print(f"parquet: {table.num_rows:,} rows "
              f"({N_CHAINS} chains x {N_TOTAL} draws), "
              f"{os.path.getsize(path) / 1e6:.1f} MB on disk, "
              f"peak chunk in memory: {CHUNK * N_CHAINS * 2 * 4 / 1e6:.1f} MB")
        dims = np.stack([table.column(f"dim_{i}").to_numpy()
                         for i in range(2)], axis=1)
        print("streamed moments:",
              "mean", dims.mean(axis=0).round(3),
              "var", dims.var(axis=0).round(3),
              "(target: [0, 1], var [4, 3])")
        assert abs(dims.mean(axis=0)[1] - 1.0) < 0.1
        assert float(result.rhat.max()) < 1.1


if __name__ == "__main__":
    main()
