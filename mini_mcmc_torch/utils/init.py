"""Initial positions (counterpart of ``mini_mcmc_tpu/utils/init.py``).

Standard-normal starting points drawn on a CPU ``torch.Generator`` and then
moved to ``device``, so one seed gives the same positions on every device.
They are not the JAX package's values (threefry and PyTorch's generator
differ); parity tests hand both packages the same numpy arrays instead.
"""

from __future__ import annotations

import secrets

import torch

DETERMINISTIC_SEED = 42  # the reference's init_det seed (mini-mcmc core.rs:404-409)


def init_with_seed(n_chains: int, dim: int, seed: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """``[n_chains, dim]`` standard-normal starting positions from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return init(n_chains, dim, gen, dtype=dtype, device=device)


def init_det(n_chains: int, dim: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """Deterministic starting positions (seed 42)."""
    return init_with_seed(n_chains, dim, DETERMINISTIC_SEED, dtype, device)


def init(n_chains: int, dim: int, generator=None, dtype=torch.float32,
         device=None) -> torch.Tensor:
    """Starting positions from a CPU ``generator`` (OS entropy if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(secrets.randbits(63))
    x = torch.randn((n_chains, dim), generator=generator, dtype=dtype)
    return x.to(device) if device is not None else x
