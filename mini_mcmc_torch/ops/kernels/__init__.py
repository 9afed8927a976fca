"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Counterpart of ``mini_mcmc_tpu/ops/pallas``: ``rng`` (Kernel 0, Philox),
``hmc`` (Kernel 1, leapfrog trajectory) and ``hmc_full`` (Kernel 2, K
fused HMC steps). Sources are under ``mini_mcmc_torch/csrc``; ``_build``
compiles them with ``nvcc`` at first CUDA use.
"""
