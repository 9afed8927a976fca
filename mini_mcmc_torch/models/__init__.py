"""Targets, proposals and Gibbs conditionals (counterpart of
``mini_mcmc_tpu.models``)."""

from .base import Conditional, Proposal, Target, validate_separable
from .discrete import (
    Categorical,
    binomial_target,
    poisson_target,
    random_walk_int_proposal,
)
from .gaussian import (
    diffable_gaussian2d,
    gaussian2d,
    gaussian_random_walk_proposal,
    isotropic_gaussian_proposal,
    isotropic_gaussian_target,
    standard_normal,
)
from .mixture import constant_conditional, gaussian_mixture_conditional
from .precondition import (
    Preconditioner,
    estimate_preconditioner,
    precondition_target,
)
from .rosenbrock import rosenbrock2d, rosenbrock_nd

__all__ = [
    "Categorical",
    "Conditional",
    "Preconditioner",
    "Proposal",
    "Target",
    "binomial_target",
    "constant_conditional",
    "diffable_gaussian2d",
    "estimate_preconditioner",
    "gaussian2d",
    "gaussian_mixture_conditional",
    "gaussian_random_walk_proposal",
    "isotropic_gaussian_proposal",
    "isotropic_gaussian_target",
    "poisson_target",
    "precondition_target",
    "random_walk_int_proposal",
    "rosenbrock2d",
    "rosenbrock_nd",
    "standard_normal",
    "validate_separable",
]
