"""Target densities (counterpart of ``mini_mcmc_tpu.models``)."""

from .base import Target
from .rosenbrock import rosenbrock2d, rosenbrock_nd

__all__ = ["Target", "rosenbrock2d", "rosenbrock_nd"]
