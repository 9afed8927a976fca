"""Target densities (counterpart of ``mini_mcmc_tpu.models``)."""

from .base import Target
from .gaussian import diffable_gaussian2d, standard_normal
from .rosenbrock import rosenbrock2d, rosenbrock_nd

__all__ = ["Target", "diffable_gaussian2d", "rosenbrock2d", "rosenbrock_nd",
           "standard_normal"]
