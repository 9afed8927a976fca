"""Sampler step kernels (counterpart of ``mini_mcmc_tpu.ops``)."""

from .chees import chees_adapt, chees_hmc_kernel, halton_u
from .elliptical import EllipticalState, elliptical_kernel
from .ensemble import EnsembleState, ensemble_kernel
from .slice import SliceState, slice_kernel

__all__ = [
    "EllipticalState",
    "EnsembleState",
    "SliceState",
    "chees_adapt",
    "chees_hmc_kernel",
    "elliptical_kernel",
    "ensemble_kernel",
    "halton_u",
    "slice_kernel",
]
