"""``mini_mcmc_torch.io`` on the CPU: the cases of tests/test_io.py on the
port, and the exports held against the JAX package's on the same numpy
cubes.

- The Python CSV writer writes the JAX package's bytes for float32,
  float64 and int32 cubes; the native writer's values parse to the same
  doubles (exact equality).
- The Arrow and Parquet tables equal the JAX package's
  (``pyarrow.Table.equals``); these cases skip where ``pyarrow`` is
  absent.
- Tensors are taken as they come, and without ``pyarrow`` each Arrow and
  Parquet entry point raises ``RuntimeError`` naming it, as the JAX
  package's do.
"""

import csv

import numpy as np
import pytest
import torch

from mini_mcmc_torch import native
from mini_mcmc_torch.io import (
    ParquetStreamWriter,
    arrow_io,
    parquet_io,
    save_arrow,
    save_csv,
    save_csv_tensor,
    save_parquet,
    save_parquet_tensor,
)
from mini_mcmc_tpu.io import save_arrow as jax_save_arrow
from mini_mcmc_tpu.io import save_csv as jax_save_csv
from mini_mcmc_tpu.io import save_parquet as jax_save_parquet
from mini_mcmc_tpu.io import save_parquet_tensor as jax_save_parquet_tensor

torch.set_num_threads(1)



# whether pyarrow imports and the native library builds is decided when a
# test runs, never at import


@pytest.fixture
def needs_pyarrow():
    pytest.importorskip("pyarrow")


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("the native library does not build here")


def _cube():
    return np.arange(2 * 3 * 2, dtype=np.float64).reshape(2, 3, 2)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


# -- the cases of tests/test_io.py ----------------------------------------


def test_csv_roundtrip_schema(tmp_path):
    data = _cube()
    save_csv(data, str(tmp_path / "a.csv"))
    rows = _rows(tmp_path / "a.csv")
    assert rows[0] == ["chain", "observation", "dim_0", "dim_1"]
    assert len(rows) == 1 + 2 * 3
    last = rows[-1]
    assert last[0] == "1" and last[1] == "2"
    np.testing.assert_allclose([float(last[2]), float(last[3])], data[1, 2])


def test_csv_integer_cube(tmp_path):
    data = np.arange(8, dtype=np.int32).reshape(1, 4, 2)
    save_csv(data, str(tmp_path / "a.csv"))
    rows = _rows(tmp_path / "a.csv")
    assert rows[1][2] == "0" and rows[1][3] == "1"


def test_csv_tensor_device_array(tmp_path):
    save_csv_tensor(torch.as_tensor(_cube()), str(tmp_path / "a.csv"))
    assert len(_rows(tmp_path / "a.csv")) == 7


@pytest.mark.usefixtures("needs_pyarrow")
def test_arrow_roundtrip(tmp_path):
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401

    data = _cube()
    save_arrow(data, str(tmp_path / "a.arrow"))
    table = pa.ipc.open_file(str(tmp_path / "a.arrow")).read_all()
    assert table.column_names == ["chain", "observation", "dim_0", "dim_1"]
    assert table.schema.field("chain").type == pa.uint32()
    assert table.schema.field("dim_0").type == pa.float64()
    assert table.num_rows == 6
    np.testing.assert_allclose(table.column("dim_0").to_numpy(),
                               data[:, :, 0].ravel())


@pytest.mark.usefixtures("needs_pyarrow")
def test_arrow_empty_input(tmp_path):
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401

    save_arrow(np.zeros((0, 0, 3)), str(tmp_path / "a.arrow"))
    table = pa.ipc.open_file(str(tmp_path / "a.arrow")).read_all()
    assert table.num_rows == 0
    assert table.column_names == ["chain", "observation", "dim_0", "dim_1",
                                  "dim_2"]


@pytest.mark.usefixtures("needs_pyarrow")
def test_parquet_chain_major(tmp_path):
    import pyarrow.parquet as pq

    save_parquet(_cube(), str(tmp_path / "a.parquet"))
    table = pq.read_table(str(tmp_path / "a.parquet"))
    assert table.column_names == ["chain", "observation", "dim_0", "dim_1"]
    np.testing.assert_array_equal(table.column("chain").to_numpy(),
                                  [0, 0, 0, 1, 1, 1])


@pytest.mark.usefixtures("needs_pyarrow")
def test_parquet_tensor_observation_major(tmp_path):
    import pyarrow.parquet as pq

    data = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    save_parquet_tensor(data, str(tmp_path / "a.parquet"))
    table = pq.read_table(str(tmp_path / "a.parquet"))
    assert table.column_names == ["observation", "chain", "dim_0", "dim_1"]
    np.testing.assert_array_equal(table.column("observation").to_numpy(),
                                  [0, 0, 1, 1, 2, 2])


@pytest.mark.usefixtures("needs_native")
def test_csv_native_fast_path_value_identical(tmp_path):
    cube = np.random.default_rng(1).standard_normal((4, 30, 3))
    # extreme magnitudes and a signed zero: the formatter's corners
    cube[0, 0] = [0.0, -0.0, 1e-300]
    cube[0, 1] = [1e300, -1.5e-8, 12345678.9]
    n, p = str(tmp_path / "n.csv"), str(tmp_path / "p.csv")
    save_csv(cube, n, native=True)
    save_csv(cube, p, native=False)
    na, pa_ = open(n).read().splitlines(), open(p).read().splitlines()
    assert na[0] == pa_[0] == "chain,observation,dim_0,dim_1,dim_2"
    assert len(na) == len(pa_) == 4 * 30 + 1
    va = np.genfromtxt(n, delimiter=",", skip_header=1)
    vb = np.genfromtxt(p, delimiter=",", skip_header=1)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(va[:, 2:], cube.reshape(-1, 3))


@pytest.mark.usefixtures("needs_native")
def test_csv_native_float32_matches_python_path(tmp_path):
    cube = np.random.default_rng(2).standard_normal((2, 10, 2)).astype(
        np.float32)
    n, p = str(tmp_path / "n.csv"), str(tmp_path / "p.csv")
    save_csv(cube, n, native=True)
    save_csv(cube, p, native=False)
    np.testing.assert_array_equal(
        np.genfromtxt(n, delimiter=",", skip_header=1),
        np.genfromtxt(p, delimiter=",", skip_header=1))


@pytest.mark.usefixtures("needs_native")
def test_csv_native_failure_raises_or_falls_back(tmp_path):
    bad = str(tmp_path / "no_such_dir" / "out.csv")
    with pytest.raises(OSError):
        save_csv(np.zeros((1, 2, 2)), bad, native=True)
    # auto: the Python writer's fallback meets the same bad path and raises
    # its own error; nothing succeeds quietly
    with pytest.raises(OSError):
        save_csv(np.zeros((1, 2, 2)), bad, native="auto")


def test_csv_both_writers_use_lf_and_wide_cube_ok(tmp_path):
    cube = np.random.default_rng(3).standard_normal((2, 3, 2))
    save_csv(cube, str(tmp_path / "p.csv"), native=False)
    assert b"\r\n" not in (tmp_path / "p.csv").read_bytes()
    if native.available():
        save_csv(cube, str(tmp_path / "n.csv"), native=True)
        assert b"\r\n" not in (tmp_path / "n.csv").read_bytes()
        # one formatted row longer than the writer's 1 MiB base buffer
        wide = np.random.default_rng(4).standard_normal((1, 1, 50000))
        save_csv(wide, str(tmp_path / "w.csv"), native=True)
        vals = np.genfromtxt(str(tmp_path / "w.csv"), delimiter=",",
                             skip_header=1)
        np.testing.assert_array_equal(vals[2:], wide[0, 0])


def test_csv_auto_falls_back_when_the_native_writer_cannot_build(
        tmp_path, monkeypatch):
    # "auto" writes with Python when the library does not build (the JAX
    # package's rule for a host writer); native=True raises instead
    from mini_mcmc_torch.io import csv_io

    def no_build(cube, path):
        raise RuntimeError("g++ failed (code 1)")

    monkeypatch.setattr(csv_io, "save_csv_cube", no_build)
    cube = _cubes()["float64"]
    save_csv(cube, str(tmp_path / "auto.csv"))
    jax_save_csv(cube, str(tmp_path / "jax.csv"), native=False)
    assert ((tmp_path / "auto.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        save_csv(cube, str(tmp_path / "n.csv"), native=True)


def test_csv_native_true_rejects_integer_cube(tmp_path):
    with pytest.raises(ValueError, match="float cube"):
        save_csv(np.zeros((1, 2, 2), np.int32), str(tmp_path / "x.csv"),
                 native=True)


# -- against the JAX package's exporters -------------------------------------


def _cubes():
    g = np.random.default_rng(5)
    f64 = g.standard_normal((3, 7, 4))
    f64[0, 0] = [0.0, -0.0, 1e-300, 1e300]
    f64[0, 1] = [np.inf, -np.inf, 5e-324, -1.5e-8]
    return {
        "float32": (g.standard_normal((3, 7, 2)) * 100).astype(np.float32),
        "float64": f64,
        "int32": g.integers(-2**31, 2**31 - 1, (2, 5, 3), dtype=np.int32),
    }


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_python_csv_is_byte_identical_to_jax(tmp_path, dtype):
    cube = _cubes()[dtype]
    ours, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    save_csv(cube, str(ours), native=False)
    jax_save_csv(cube, str(theirs), native=False)
    assert ours.read_bytes() == theirs.read_bytes()
    # a tensor of the same cube writes the same bytes
    save_csv_tensor(torch.from_numpy(cube), str(tmp_path / "t.csv"),
                    native=False)
    assert (tmp_path / "t.csv").read_bytes() == theirs.read_bytes()
    # auto writes integers with the Python writer, so the same bytes too
    if dtype == "int32":
        save_csv(cube, str(tmp_path / "auto.csv"))
        assert (tmp_path / "auto.csv").read_bytes() == theirs.read_bytes()


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_native_csv_parses_to_the_jax_writers_doubles(tmp_path, dtype):
    cube = _cubes()[dtype]
    save_csv_tensor(torch.from_numpy(cube), str(tmp_path / "n.csv"),
                    native=True)
    jax_save_csv(cube, str(tmp_path / "j.csv"), native=False)
    got = np.genfromtxt(str(tmp_path / "n.csv"), delimiter=",",
                        skip_header=1)
    want = np.genfromtxt(str(tmp_path / "j.csv"), delimiter=",",
                         skip_header=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:, 2:], cube.astype(np.float64).reshape(-1, cube.shape[-1]))


@pytest.mark.usefixtures("needs_pyarrow")
@pytest.mark.parametrize("what", ["arrow", "parquet", "parquet_tensor",
                                  "arrow_empty"])
def test_tables_equal_the_jax_packages(tmp_path, what):
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401
    import pyarrow.parquet as pq

    cube = _cubes()["float32"]
    if what == "arrow_empty":
        cube = np.zeros((0, 0, 3), np.float32)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    if what.startswith("arrow"):
        save_arrow(torch.from_numpy(cube), ours)
        jax_save_arrow(cube, theirs)
        a = pa.ipc.open_file(ours).read_all()
        b = pa.ipc.open_file(theirs).read_all()
    else:
        port_fn, jax_fn = ((save_parquet, jax_save_parquet)
                           if what == "parquet" else
                           (save_parquet_tensor, jax_save_parquet_tensor))
        port_fn(torch.from_numpy(cube), ours)
        jax_fn(cube, theirs)
        a, b = pq.read_table(ours), pq.read_table(theirs)
    assert a.schema.equals(b.schema)
    assert a.equals(b)


def test_without_pyarrow_every_table_export_raises(monkeypatch, tmp_path):
    # the card machine has no pyarrow: each entry point raises with the JAX
    # package's words, and no file is written
    monkeypatch.setattr(arrow_io, "_HAVE_PYARROW", False)
    monkeypatch.setattr(parquet_io, "_HAVE_PYARROW", False)
    with pytest.raises(RuntimeError, match="pyarrow is not available; "
                       "Arrow export disabled"):
        save_arrow(_cube(), str(tmp_path / "a.arrow"))
    for call in (lambda: save_parquet(_cube(), str(tmp_path / "b")),
                 lambda: save_parquet_tensor(_cube(), str(tmp_path / "c")),
                 lambda: ParquetStreamWriter(str(tmp_path / "d"))):
        with pytest.raises(RuntimeError, match="pyarrow is not available; "
                           "Parquet export disabled"):
            call()
    assert list(tmp_path.iterdir()) == []
