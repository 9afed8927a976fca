"""``mini_mcmc_torch.native`` on the CPU: the cases of tests/test_native.py
with the port's ``stats`` and ``diagnostics`` held against the port's
binding of the C++ oracle (``native/mcmc_native.cpp``), at that file's
tolerances (rtol 1e-4 on R-hat and the autocovariances, 2e-3 to 5e-3 on
ESS); and the binding's build: into ``build/mini_mcmc_torch/`` only,
under a name that hashes the source, and safe when several threads build
at once.
"""

import threading

import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch import native
from mini_mcmc_torch import stats as S

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _needs_native():
    # decided when a test runs (the first one builds the library), never
    # at import
    if not native.available():
        pytest.skip("the native library does not build here")


def _ar1(rng, c, n, p, phi):
    eps = rng.normal(size=(c, n, p))
    x = np.empty((c, n, p), np.float32)
    x[:, 0] = eps[:, 0]
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x


def test_native_autocov_matches_port():
    x = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    got = native.autocov_bf(torch.from_numpy(x))
    want = S.autocov_bf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_native_autocov_golden():
    data = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    expected = np.array([[1.25], [0.3125], [-0.375], [-0.5625]], np.float32)
    np.testing.assert_allclose(native.autocov_bf(data), expected, atol=1e-6)


def test_native_geyer_tau_matches_port():
    rng = np.random.default_rng(1)
    n, p = 40, 4
    lags = np.arange(n)[:, None]
    rho = ((0.8 ** lags) * rng.uniform(0.5, 1.5, (1, p))
           - 0.01 * lags).astype(np.float32)
    got = native.geyer_tau(rho)
    want = S._geyer_tau(torch.from_numpy(rho)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_native_full_pipeline_matches_port():
    x = _ar1(np.random.default_rng(2), 4, 120, 3, 0.7)
    rhat_n, ess_n = native.split_rhat_ess(x)
    rhat_t, ess_t = S.split_rhat_mean_ess(torch.from_numpy(x))
    np.testing.assert_allclose(rhat_n, rhat_t.numpy(), rtol=1e-4)
    np.testing.assert_allclose(ess_n, ess_t.numpy(), rtol=2e-3)


def test_native_pipeline_on_real_sampler_output():
    mh = mt.MetropolisHastings(
        mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        mt.isotropic_gaussian_proposal(1.0), mt.init_det(4, 2, device="cpu"),
        device="cpu").seed(42)
    sample = mh.run(400, 100)
    rhat_n, ess_n = native.split_rhat_ess(sample)  # a tensor, as it comes
    rhat_t, ess_t = S.split_rhat_mean_ess(sample)
    np.testing.assert_allclose(rhat_n, rhat_t.numpy(), rtol=1e-3)
    np.testing.assert_allclose(ess_n, ess_t.numpy(), rtol=5e-3)


def test_native_pipeline_randomized_shape_sweep():
    # odd and even N, the split length's brute-force branch (n' <= 100)
    # and the FFT one, the fewest chains, one parameter, several mixing
    # speeds: the C++ oracle, the chain-major and the time-major paths
    rng = np.random.default_rng(7)
    for c, n, p, phi in [(2, 41, 1, 0.3), (3, 250, 2, 0.9),
                         (8, 301, 4, 0.0), (5, 64, 3, -0.5)]:
        x = _ar1(rng, c, n, p, phi)
        rhat_n, ess_n = native.split_rhat_ess(x)
        rhat_c, ess_c = S.split_rhat_mean_ess(torch.from_numpy(x))
        rhat_m, ess_m = S.split_rhat_mean_ess(
            torch.from_numpy(x).transpose(0, 1), time_major=True)
        cfg = str((c, n, p, phi))
        np.testing.assert_allclose(rhat_n, rhat_c.numpy(), rtol=1e-4,
                                   err_msg=cfg)
        np.testing.assert_allclose(ess_n, ess_c.numpy(), rtol=5e-3,
                                   err_msg=cfg)
        np.testing.assert_allclose(rhat_m.numpy(), rhat_c.numpy(),
                                   rtol=1e-5, err_msg=cfg)
        np.testing.assert_allclose(ess_m.numpy(), ess_c.numpy(), rtol=1e-3,
                                   err_msg=cfg)


def _diag_pair(cube):
    d = mt.rank_normalized_diagnostics(torch.from_numpy(cube))
    return d, native.rank_normalized_diag(cube)


def _assert_diag_close(cube, rtol_rhat=1e-4, rtol_ess=2e-3):
    d, (rb, rf, eb, et) = _diag_pair(cube)
    np.testing.assert_allclose(d.rhat_bulk.numpy(), rb, rtol=rtol_rhat)
    np.testing.assert_allclose(d.rhat_folded.numpy(), rf, rtol=rtol_rhat)
    np.testing.assert_allclose(d.ess_bulk.numpy(), eb, rtol=rtol_ess)
    np.testing.assert_allclose(d.ess_tail.numpy(), et, rtol=rtol_ess)


def test_native_rank_normalized_autocorrelated():
    rng = np.random.default_rng(0)
    c, n, p = 6, 400, 3
    cube = np.zeros((c, n, p), np.float32)
    innov = rng.standard_normal((c, n, p)).astype(np.float32)
    for t in range(1, n):
        cube[:, t] = 0.7 * cube[:, t - 1] + innov[:, t]
    _assert_diag_close(cube)


def test_native_rank_normalized_heavy_tailed():
    cube = np.random.default_rng(1).standard_cauchy((8, 160, 2)).astype(
        np.float32)
    d, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert float(d.rhat.max()) < 1.02
    assert float(np.min(eb)) > 0.5 * 8 * 160


def test_native_rank_normalized_scale_mismatch():
    cube = np.random.default_rng(2).standard_normal((4, 300, 2)).astype(
        np.float32)
    cube[2:] *= 3.0
    _, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert np.all(rf > 1.15), rf
    assert np.all(rf > rb + 0.1), (rf, rb)


def test_native_rank_normalized_location_mismatch():
    cube = np.random.default_rng(3).standard_normal((4, 300, 2)).astype(
        np.float32)
    cube[0] += 5.0
    _, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert np.all(rb > 1.5), rb
    assert np.all(et < 100.0), et


def test_build_writes_only_its_hashed_library(tmp_path, monkeypatch):
    # the loaded library lives in build/mini_mcmc_torch/, never native/
    so, flags = native.build()
    assert so.parent == native.BUILD_DIR
    assert so.name.startswith("libmcmc_native_") and so.suffix == ".so"
    assert native.build() == (so, flags)  # unchanged: reused, not rebuilt
    assert native.load().cxx_flags == flags
    assert set(flags) >= set(native.CXX_FLAGS) - {native.OPENMP_FLAG}
    # several builds at once into an empty directory: each compiles to a
    # name of its own and renames it into place; one library remains
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    got, errors = [], []

    def build():
        try:
            got.append(native.build()[0])
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert len(set(got)) == 1 and got[0].name == so.name
    assert [p.name for p in (tmp_path / "b").iterdir()] == [so.name]


def test_build_without_openmp_runtime(tmp_path, monkeypatch):
    # a toolchain whose -fopenmp fails for want of libgomp (as on a machine
    # without the OpenMP runtime's development files): the library builds
    # without the flag, says so in its flags, and gives the same results
    import subprocess as sp

    real_run = sp.run

    def run(cmd, *a, **kw):
        if native.OPENMP_FLAG in cmd and "-o" in cmd:
            return sp.CompletedProcess(cmd, 1, "", "g++: fatal error: "
                                       "cannot read spec file "
                                       "'libgomp.spec'")
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", run)
    so, flags = native.build()
    assert native.OPENMP_FLAG not in flags and so.parent == tmp_path
    assert list(tmp_path.iterdir()) == [so]
    monkeypatch.setattr(native.subprocess, "run", real_run)
    import ctypes

    lib = ctypes.CDLL(str(so))
    x = np.random.default_rng(5).standard_normal((3, 64, 2)).astype(
        np.float32)
    rhat, ess = np.empty(2, np.float32), np.empty(2, np.float32)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.mcmc_split_rhat_ess.argtypes = [f32, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, f32, f32]
    lib.mcmc_split_rhat_ess(x.ctypes.data_as(f32), 3, 64, 2,
                            rhat.ctypes.data_as(f32), ess.ctypes.data_as(f32))
    want = native.split_rhat_ess(x)
    np.testing.assert_array_equal(rhat, want[0])
    np.testing.assert_array_equal(ess, want[1])
    # any other failure raises
    monkeypatch.setattr(native.subprocess, "run", lambda cmd, *a, **kw: (
        sp.CompletedProcess(cmd, 1, "", "error: expected ';'")
        if "-o" in cmd else real_run(cmd, *a, **kw)))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "other")
    with pytest.raises(RuntimeError, match="expected"):
        native.build()
