"""Sampler step kernels (counterpart of ``mini_mcmc_tpu.ops``)."""

from .adapt import dual_average_step_size
from .ais import AISResult, ais_log_z, linear_betas, make_anneal, resample
from .chees import chees_adapt, chees_hmc_kernel, halton_u
from .elliptical import EllipticalState, elliptical_kernel
from .ensemble import EnsembleState, ensemble_kernel
from .gibbs import GibbsState, gibbs_kernel
from .hmc import HMCState, hmc_kernel
from .mh import MHState, mh_kernel
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
from .tempering import PTState, geometric_betas, tempering_kernel, tune_betas

__all__ = [
    "AISResult",
    "EllipticalState",
    "EnsembleState",
    "GibbsState",
    "HMCState",
    "MHState",
    "PTState",
    "SGHMCState",
    "SGLDState",
    "SMCResult",
    "SliceState",
    "ais_log_z",
    "chees_adapt",
    "chees_hmc_kernel",
    "dual_average_step_size",
    "elliptical_kernel",
    "ensemble_kernel",
    "geometric_betas",
    "gibbs_kernel",
    "halton_u",
    "hmc_kernel",
    "linear_betas",
    "make_anneal",
    "make_smc_run",
    "mh_kernel",
    "minibatch_grad",
    "polynomial_decay",
    "resample",
    "sghmc_kernel",
    "sgld_kernel",
    "slice_kernel",
    "smc_log_z",
    "target_grad",
    "tempering_kernel",
    "tune_betas",
]
