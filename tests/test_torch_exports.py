"""Export parity: every public name of the JAX package's ``__all__``
lists is exported by the port's counterpart module and importable from
it, but for the named removals. The JAX lists are read from the source
with ``ast``, so this test imports neither JAX nor the JAX package.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: JAX module -> the port's
MODULES = {
    "mini_mcmc_tpu": "mini_mcmc_torch",
    "mini_mcmc_tpu.ops": "mini_mcmc_torch.ops",
    "mini_mcmc_tpu.models": "mini_mcmc_torch.models",
    "mini_mcmc_tpu.utils": "mini_mcmc_torch.utils",
    "mini_mcmc_tpu.parallel": "mini_mcmc_torch.parallel",
}
#: names the port does not export, and why (ROADMAP.md)
REMOVALS = {
    # keys draws by place under one Philox key: no per-chain keys
    "chain_keys": "removal",
}


def _jax_all(module: str) -> list:
    path = ROOT.joinpath(*module.split("."), "__init__.py")
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "__all__"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("jax_module", list(MODULES))
def test_port_exports_every_jax_name(jax_module):
    port = importlib.import_module(MODULES[jax_module])
    wanted = [n for n in _jax_all(jax_module) if n not in REMOVALS]
    missing = [n for n in wanted if n not in port.__all__]
    assert not missing, f"{port.__name__}.__all__ lacks {missing}"
    unimportable = [n for n in wanted if not hasattr(port, n)]
    assert not unimportable, unimportable
    for name in wanted:
        exec(f"from {port.__name__} import {name}", {})


def test_port_all_lists_are_importable_and_removals_current():
    for jax_module, port_module in MODULES.items():
        port = importlib.import_module(port_module)
        assert len(set(port.__all__)) == len(port.__all__)
        assert all(hasattr(port, n) for n in port.__all__), port_module
        # a removal the port has since gained no longer belongs here
        assert not set(REMOVALS) & set(port.__all__), port_module
    # every removal still names a JAX export
    jax_names = set().union(*(_jax_all(m) for m in MODULES))
    assert set(REMOVALS) <= jax_names
