"""Utilities (counterpart of ``mini_mcmc_tpu.utils``)."""
