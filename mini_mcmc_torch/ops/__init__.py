"""Sampler step kernels (counterpart of ``mini_mcmc_tpu.ops``)."""

from .ais import AISResult, ais_log_z, linear_betas, make_anneal, resample
from .chees import chees_adapt, chees_hmc_kernel, halton_u
from .elliptical import EllipticalState, elliptical_kernel
from .ensemble import EnsembleState, ensemble_kernel
from .sgmcmc import (
    SGHMCState,
    SGLDState,
    minibatch_grad,
    polynomial_decay,
    sghmc_kernel,
    sgld_kernel,
    target_grad,
)
from .slice import SliceState, slice_kernel
from .smc import SMCResult, make_smc_run, smc_log_z

__all__ = [
    "AISResult",
    "EllipticalState",
    "EnsembleState",
    "SGHMCState",
    "SGLDState",
    "SMCResult",
    "SliceState",
    "ais_log_z",
    "chees_adapt",
    "chees_hmc_kernel",
    "elliptical_kernel",
    "ensemble_kernel",
    "halton_u",
    "linear_betas",
    "make_anneal",
    "make_smc_run",
    "minibatch_grad",
    "polynomial_decay",
    "resample",
    "sghmc_kernel",
    "sgld_kernel",
    "slice_kernel",
    "smc_log_z",
    "target_grad",
]
