"""Posteriors of the JAX package's examples and benchmark stages, and its
examples themselves, in PyTorch (counterpart of ``examples/``, whose
files import JAX): one module per example with a ``main(device="cuda",
...)``."""

import torch


def nuts_tier(device) -> dict:
    """The NUTS tier an example takes on ``device``: the fused one on CUDA
    (``use_pallas="full"``, Kernel 4, a whole step a launch), where the
    lockstep tier dispatches 80-170 PyTorch operations a leapfrog one by
    one from the host, 2-3 ms a leapfrog on an H100; the lockstep tier on
    the CPU, as the JAX examples run."""
    return ({"use_pallas": "full"} if torch.device(device).type == "cuda"
            else {})
