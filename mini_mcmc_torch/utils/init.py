"""Initial positions (counterpart of ``mini_mcmc_tpu/utils/init.py``).

Standard-normal starting points drawn on a CPU ``torch.Generator`` and then
moved to ``device``, so one seed gives the same positions on every device.
They are not the JAX package's values (threefry and PyTorch's generator
differ); parity tests hand both packages the same numpy arrays instead.

The port runs on the GPU: every entry point takes ``device="cuda"`` by
default and raises without one. Pass ``device="cpu"`` to run the plain
PyTorch twins on the CPU.
"""

from __future__ import annotations

import secrets

import torch

DETERMINISTIC_SEED = 42  # the reference's init_det seed (mini-mcmc core.rs:404-409)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    PyTorch sees none, instead of carrying on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mini_mcmc_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def init_with_seed(n_chains: int, dim: int, seed: int,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``[n_chains, dim]`` standard-normal starting positions from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return init(n_chains, dim, gen, dtype=dtype, device=device)


def init_det(n_chains: int, dim: int, dtype=torch.float32,
             device="cuda") -> torch.Tensor:
    """Deterministic starting positions (seed 42)."""
    return init_with_seed(n_chains, dim, DETERMINISTIC_SEED, dtype, device)


def init(n_chains: int, dim: int, generator=None, dtype=torch.float32,
         device="cuda") -> torch.Tensor:
    """Starting positions from a CPU ``generator`` (OS entropy if None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(secrets.randbits(63))
    x = torch.randn((n_chains, dim), generator=generator, dtype=dtype)
    return x.to(device)
