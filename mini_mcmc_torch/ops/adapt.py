"""Dual-averaging step-size adaptation for fixed-trajectory samplers.

Counterpart of ``mini_mcmc_tpu/ops/adapt.py``: the NUTS step's dual
averaging (Hoffman & Gelman Algorithm 6, with ``GAMMA``, ``T_0`` and
``KAPPA`` from ``ops/nuts.py``) factored out, so that HMC, MALA and MH warm
up their step size or proposal scale the same way.

The JAX package runs the adaptation as one ``lax.scan``; here it is a
Python loop whose iterate stays in float32 0-d tensors on the state's
device (as JAX's does without x64), or float64 ones when the state is
float64 (as JAX's scan carries float64 scalars then,
``tests/test_float64.py``), so that a float64 step size reaches Kernel 1
at double. Each step's acceptance statistic is a
device tensor, and the step size goes to the step as one, so nothing in
the loop waits for the device; one ``float()`` at the end reads the tuned
step size.
"""

from __future__ import annotations

import torch

from ..runner import StepKey
from .nuts import GAMMA, KAPPA, T_0


def dual_average_step_size(step_eps, state, key: StepKey, n_adapt: int,
                           eps0: float, target_accept: float):
    """Warm up ``eps`` by dual averaging over ``n_adapt`` sampler steps.

    ``step_eps(state, key, eps) -> (state, mean_alpha)`` advances one
    sampler step at the step size ``eps`` (a 0-d tensor on the state's
    device, float64 for a float64 state and float32 otherwise) and
    returns the cross-chain mean Metropolis acceptance probability
    (NaN-divergent proposals counted as 0). Adaptation step m
    (1-based) runs under ``key._replace(step=key.step + m)``, the
    counterpart of ``fold_in(key, m)``: the fused kernels key their draws
    by (seed, chain, step), so every step draws anew. The update starts at
    ``mu = ln(10 eps0)``, ``h_bar = 0``, ``log_eps_bar = 0``, moves
    ``log_eps`` toward ``mu`` against the running acceptance deficit
    ``h_bar`` and averages the iterates with weight ``m^-kappa``.

    Returns ``(state, eps_tuned, mean_alpha_trace [n_adapt])``: the state
    after the adaptation leg, the averaged step size ``exp(log_eps_bar)``
    as a host float, and the per-step acceptance trace (the iterate's
    dtype, on the state's device).
    """
    if n_adapt < 1:
        raise ValueError(f"n_adapt must be >= 1, got {n_adapt}")
    pos = state.positions
    real = dict(dtype=torch.float64 if pos.dtype == torch.float64
               else torch.float32, device=pos.device)
    mu = torch.log(torch.tensor(10.0 * eps0, **real))
    log_eps = torch.log(torch.tensor(eps0, **real))
    log_eps_bar = torch.zeros((), **real)
    h_bar = torch.zeros((), **real)
    # every step's coefficients at once, in float32 as the scan computes
    # them: 1 / (m + t0), sqrt(m) / gamma and m^-kappa
    m_f = torch.arange(1, n_adapt + 1, **real)
    frac = 1.0 / (m_f + T_0)
    shrink = torch.sqrt(m_f) / GAMMA
    weight = m_f ** (-KAPPA)
    alphas = torch.empty((n_adapt,), **real)
    for i in range(n_adapt):
        state, alpha = step_eps(state, key._replace(step=key.step + i + 1),
                                torch.exp(log_eps))
        alphas[i] = alpha
        deficit = target_accept - alphas[i]
        h_bar = (1.0 - frac[i]) * h_bar + frac[i] * deficit
        log_eps = mu - shrink[i] * h_bar
        log_eps_bar = weight[i] * log_eps + (1.0 - weight[i]) * log_eps_bar
    return state, float(torch.exp(log_eps_bar)), alphas
