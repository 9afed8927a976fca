"""The port stands alone: ``mini_mcmc_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package. Checked in a fresh interpreter in which
``import jax`` and ``import mini_mcmc_tpu`` fail, so any import of either,
however indirect, breaks the import of the port.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib
import pkgutil
import sys

sys.modules["jax"] = None
sys.modules["mini_mcmc_tpu"] = None
import mini_mcmc_torch

names = ["mini_mcmc_torch"]
for info in pkgutil.walk_packages(mini_mcmc_torch.__path__,
                                  "mini_mcmc_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke  # its import block; main() runs only as a script

# the MH, Gibbs, separable HMC, tempering, metric, run-surface,
# transform, ChEES/ensemble/slice/elliptical, AIS/SMC/SG-MCMC and
# run-tooling slices among them
assert {"mini_mcmc_torch.ops.mh", "mini_mcmc_torch.ops.gibbs",
        "mini_mcmc_torch.checkpoint", "mini_mcmc_torch.io",
        "mini_mcmc_torch.io.csv_io", "mini_mcmc_torch.io.arrow_io",
        "mini_mcmc_torch.io.parquet_io", "mini_mcmc_torch.native",
        "mini_mcmc_torch.utils.timer",
        "mini_mcmc_torch.ops.ais", "mini_mcmc_torch.ops.smc",
        "mini_mcmc_torch.ops.sgmcmc",
        "mini_mcmc_torch.ops.chees", "mini_mcmc_torch.ops.ensemble",
        "mini_mcmc_torch.ops.slice", "mini_mcmc_torch.ops.elliptical",
        "mini_mcmc_torch.progress", "mini_mcmc_torch.stream",
        "mini_mcmc_torch.models.precondition",
        "mini_mcmc_torch.ops.kernels.mh_full",
        "mini_mcmc_torch.ops.kernels.gibbs_full",
        "mini_mcmc_torch.models.discrete",
        "mini_mcmc_torch.models.mixture",
        "mini_mcmc_torch.ops.tempering",
        "mini_mcmc_torch.ops.kernels.hmc_sep",
        "mini_mcmc_torch.ops.kernels.pt_full",
        "mini_mcmc_torch.models.transforms",
        "mini_mcmc_torch.examples.eight_schools"} <= set(names), names

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mini_mcmc_tpu")
                and sys.modules[m] is not None)
print(len(names), loaded)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert loaded.strip() == "[]"
    assert int(n_modules) >= 54  # every module of the package was imported
