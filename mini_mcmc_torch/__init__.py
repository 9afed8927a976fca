"""mini_mcmc_torch: the PyTorch + CUDA port of mini_mcmc_tpu.

Lockstep batched HMC over ``[n_chains, dim]`` tensors, with the fused tiers
(``HMC(use_pallas=True | "full")``) run by hand-written CUDA kernels for
Hopper (``csrc/``) on CUDA tensors and by their plain PyTorch twins on CPU
tensors. The module names mirror ``mini_mcmc_tpu``'s, which stays the
reference the port is tested against; this package never imports it or JAX.
"""

from .diagnostics import ModernDiagnostics, rank_normalized_diagnostics
from .models import rosenbrock_nd
from .samplers import HMC
from .stats import split_rhat_mean_ess
from .utils.init import init, init_det, init_with_seed

__all__ = [
    "HMC",
    "ModernDiagnostics",
    "init",
    "init_det",
    "init_with_seed",
    "rank_normalized_diagnostics",
    "rosenbrock_nd",
    "split_rhat_mean_ess",
]
