"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Counterpart of ``mini_mcmc_tpu/ops/pallas``: ``rng`` (Kernel 0, Philox),
``hmc`` (Kernel 1, leapfrog trajectory), ``hmc_full`` (Kernel 2, K fused
HMC steps), ``nuts_subtree`` (Kernel 3, one NUTS subtree) and
``nuts_full`` (Kernel 4, a whole NUTS step). Sources are under
``mini_mcmc_torch/csrc``; ``_build`` compiles them with ``nvcc`` at first
CUDA use.
"""
