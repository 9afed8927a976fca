"""Sampler step kernels (counterpart of ``mini_mcmc_tpu.ops``)."""
