"""Sample-cube exporters: CSV, Arrow IPC and Parquet (counterpart of
``mini_mcmc_tpu.io``).

CSV needs nothing beyond numpy (the native writer a C++ compiler); Arrow
and Parquet need ``pyarrow`` and raise ``RuntimeError`` without it, as the
JAX package's exporters do.
"""

from .arrow_io import save_arrow
from .csv_io import save_csv, save_csv_tensor
from .parquet_io import ParquetStreamWriter, save_parquet, save_parquet_tensor

__all__ = [
    "ParquetStreamWriter",
    "save_arrow",
    "save_csv",
    "save_csv_tensor",
    "save_parquet",
    "save_parquet_tensor",
]
