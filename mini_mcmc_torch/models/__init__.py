"""Targets, proposals and Gibbs conditionals (counterpart of
``mini_mcmc_tpu.models``)."""

from .base import (
    Conditional,
    Proposal,
    Target,
    validate_dc_forms,
    validate_separable,
)
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
    neal_funnel,
    standard_normal,
)
from .mixture import constant_conditional, gaussian_mixture_conditional
from .precondition import (
    Preconditioner,
    estimate_preconditioner,
    precondition_target,
)
from .rosenbrock import rosenbrock2d, rosenbrock_nd
from .transforms import (
    Bijector,
    CoordinateTransform,
    identity,
    interval,
    lower_bounded,
    positive,
    transformed_target,
    upper_bounded,
)
from ..ops.kernels.user_density import derive_grad_dc, derive_logp_dc

__all__ = [
    "Bijector",
    "Categorical",
    "Conditional",
    "CoordinateTransform",
    "Preconditioner",
    "Proposal",
    "Target",
    "binomial_target",
    "constant_conditional",
    "derive_grad_dc",
    "derive_logp_dc",
    "diffable_gaussian2d",
    "estimate_preconditioner",
    "gaussian2d",
    "gaussian_mixture_conditional",
    "gaussian_random_walk_proposal",
    "identity",
    "interval",
    "isotropic_gaussian_proposal",
    "isotropic_gaussian_target",
    "lower_bounded",
    "neal_funnel",
    "poisson_target",
    "positive",
    "precondition_target",
    "random_walk_int_proposal",
    "rosenbrock2d",
    "rosenbrock_nd",
    "standard_normal",
    "transformed_target",
    "upper_bounded",
    "validate_dc_forms",
    "validate_separable",
]
