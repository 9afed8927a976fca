"""ChEES-HMC: jittered-trajectory HMC whose trajectory length is adapted
from a cross-chain criterion (Hoffman, Radul & Sountsov, AISTATS 2021).

Counterpart of ``mini_mcmc_tpu/ops/chees.py``. Every chain integrates for
the same time ``t = u T`` with the same leapfrog count ``L = clip(ceil(t /
eps), 1, max_leapfrog)``, so the batch stays in lockstep and the only
data-dependent quantity is one scalar. Here that scalar is a host integer,
known without reading the device:

- the production kernel (:func:`chees_hmc_kernel`) draws ``u`` on the host
  by place, Philox word x at (chain 0, step, ``CHEES_U_DRAW``) under the
  run's key, so a ``run()`` makes no device-to-host read;
- the warm-up (:func:`chees_adapt`) takes ``u`` from the Halton sequence
  and keeps its scalar recurrence (dual averaging of ``eps``, Adam on
  ``log T``) in float32 on the host, as the JAX package keeps it in
  float32 without x64; ``L`` depends on the adapted ``eps``, so each
  adaptation step reads one pair back: the mean acceptance and the ChEES
  gradient.

The momentum and accept draws come from ``key.generator`` on the
positions' device; :func:`jittered_step` takes them as inputs, so a test
can hand it the JAX package's own draws. No kernel: the JAX package runs
this in XLA, and so the port runs it in PyTorch.

Under a state split (``key.state``: D split over a ``"state"`` axis) a
step draws the global ``[C, D]`` momenta's block, runs the target on a
DTensor view of its D-slice (``parallel.mesh.SliceTarget``), the
gradient alone at every leapfrog but the last, which also takes the
rank's share of the logp, and sums that share with the two kinetic
energies in one ``[3, C]`` all-reduce: one a step on a target whose
gradient is elementwise. The warm-up sums the ChEES statistic's three
sums over D in one more ``[3, C]`` all-reduce; its cross-chain centring
is per coordinate and stays on the rank's columns. Every shard of a chain
then takes the same accept decision, and every rank reads the same
``(alpha, g)`` and adapts alike.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import (
    chain_draw,
    gather_chains,
    split,
    state_draw,
    state_sum,
)
from ..parallel.mesh import SliceTarget
from ..runner import StepKey
from .hmc import HMCState
from .kernels import rng
from .nuts import GAMMA, KAPPA, T_0

#: Philox draw index (chain 0, sub-draw 0, word x) of the production
#: kernel's trajectory jitter ``u`` at each step
CHEES_U_DRAW = 0x40000

_MASK = 0xFFFFFFFF


def halton_u(m) -> torch.Tensor:
    """Base-2 radical inverse of integer ``m >= 1`` (an int or an integer
    tensor) as float32 in (0, 1): the 32-bit index bit-reversed and scaled
    by 2^-32 (``chees.py:44-62``), bit for bit."""
    b = torch.as_tensor(m, dtype=torch.int64) & _MASK
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    b = ((b << 16) & _MASK) | (b >> 16)
    return b.to(torch.float32) * 2.0**-32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def n_leapfrog(u, traj_len, eps, max_leapfrog: int) -> int:
    """``clip(ceil(u traj_len / eps), 1, max_leapfrog)`` with the product
    and the quotient rounded to float32, as the JAX step computes them
    (a float64 quotient could land on the other side of an integer)."""
    q = float((_f32(u) * _f32(traj_len)) / _f32(eps))
    if math.isnan(q):
        return 1
    if math.isinf(q):
        return max_leapfrog if q > 0 else 1
    return min(max(math.ceil(q), 1), max_leapfrog)


def _dynamic_leapfrog(target, pos, mom, logp, grad, eps: float,
                      n_steps: int, state_group=None):
    """``n_steps`` leapfrog steps with the cached half-step gradient
    (``chees.py:65-87``): one gradient evaluation per step; ``n_steps`` a
    host integer shared by every chain; the gradient alone at every step
    but the last, which also takes the logp (on a rank's D-slice,
    ``state_group`` split, the rank's share of it)."""
    half_eps = eps * 0.5
    if split(state_group):
        tgt = SliceTarget(target, state_group)
        last = tgt.batch_logp_and_grad_share
    else:
        tgt, last = target, target.batch_logp_and_grad
    for i in range(n_steps):
        mom = mom + grad * half_eps
        pos = pos + eps * mom
        if i < n_steps - 1:
            grad = tgt.batch_grad(pos)
        else:
            logp, grad = last(pos)
        mom = mom + grad * half_eps
    return pos, mom, logp, grad


def jittered_step(target, state: HMCState, eps: float, n_steps: int,
                  mom0: torch.Tensor, u_acc: torch.Tensor, state_group=None):
    """One jittered-trajectory HMC step on given draws (``chees.py:
    90-121``): momentum ``mom0 [C, D]``, accept uniforms ``u_acc [C]``,
    ``n_steps`` leapfrogs at step size ``eps`` (a float32 value). Returns
    ``(state, pos_prop, mom_prop, alpha_c)``: the new state, the proposal's
    endpoint and final velocity, and each chain's acceptance probability
    (NaN counted as 0), what the ChEES gradient needs. On a rank's D-slice
    (``state_group`` split) the proposal's logp share and both kinetic
    energies cross the state axis in one ``[3, C]`` all-reduce."""
    ke0 = torch.sum(mom0 * mom0, dim=1)
    pos_prop, mom_prop, logp_prop, grad_prop = _dynamic_leapfrog(
        target, state.positions, mom0, state.logp, state.grad, eps, n_steps,
        state_group)
    ke1 = torch.sum(mom_prop * mom_prop, dim=1)
    if split(state_group):
        logp_prop, ke0, ke1 = state_sum(torch.stack([logp_prop, ke0, ke1]),
                                        state_group)
    h_current = -state.logp + 0.5 * ke0
    h_proposed = -logp_prop + 0.5 * ke1
    accept_logp = h_current - h_proposed
    alpha_c = torch.nan_to_num(torch.exp(torch.clamp(accept_logp, max=0.0)),
                               nan=0.0)
    accept = accept_logp >= torch.log(u_acc)  # NaN compares False
    new_state = HMCState(
        positions=torch.where(accept[:, None], pos_prop, state.positions),
        logp=torch.where(accept, logp_prop, state.logp),
        grad=torch.where(accept[:, None], grad_prop, state.grad),
    )
    return new_state, pos_prop, mom_prop, alpha_c


def step_draws(positions: torch.Tensor, gen: torch.Generator, chains=None,
               state_group=None):
    """A step's momentum ``[C, D]`` and accept uniforms ``[C]`` from
    ``gen`` on the positions' device (a shard's rows of the global draws
    under ``chains``, the momenta's D-slice under ``state_group``)."""
    like = dict(dtype=positions.dtype, device=positions.device)
    mom0 = state_draw(chains, state_group, lambda s: torch.randn(
        s, generator=gen, **like), positions.shape)
    u_acc = chain_draw(chains, lambda s: torch.rand(s, generator=gen, **like),
                       (positions.shape[0],))
    return mom0, u_acc


def chees_grad_logT(positions, pos_prop, mom_prop, alpha_c,
                    t: float, state_group=None) -> torch.Tensor:
    """The acceptance-weighted estimate of d ChEES / d log T
    (``chees.py:124-151``), a 0-d tensor on the positions' device: per
    chain ``(||xc'||^2 - ||xc||^2) (xc' . v')`` with the endpoints centred
    across chains, weighted by ``alpha_c``, non-finite terms dropped (0 if
    every chain diverged), times ``dt / dlog T = t``. On a rank's D-slice
    (``state_group`` split) the centring stays on its columns and the
    three sums over D cross the state axis in one ``[3, C]`` all-reduce."""
    xc = positions - positions.mean(dim=0, keepdim=True)
    xpc = pos_prop - pos_prop.mean(dim=0, keepdim=True)
    sq_prop, sq, dot = (torch.sum(xpc * xpc, dim=1), torch.sum(xc * xc, dim=1),
                        torch.sum(xpc * mom_prop, dim=1))
    if split(state_group):
        sq_prop, sq, dot = state_sum(torch.stack([sq_prop, sq, dot]),
                                     state_group)
    d = sq_prop - sq
    g_i = d * dot
    ok = torch.isfinite(g_i)
    w = torch.where(ok, alpha_c, 0.0)
    wsum = torch.sum(w)
    g = torch.where(
        wsum > 0.0,
        torch.sum(w * torch.where(ok, g_i, 0.0)) / torch.clamp(wsum,
                                                              min=1e-12),
        0.0)
    return g * t


def _all_chains(chains, positions, pos_prop, mom_prop, alpha_c):
    """The step's ``[C, D]`` endpoints, momenta and ``[C]`` acceptances
    over every shard (one all-gather), as the unsharded step has them."""
    if chains is None:
        return positions, pos_prop, mom_prop, alpha_c
    d = positions.shape[1]
    packed = torch.cat([positions, pos_prop, mom_prop,
                        alpha_c[:, None].to(positions.dtype)], dim=1)
    full = gather_chains(packed, chains)
    return (full[:, :d], full[:, d:2 * d], full[:, 2 * d:3 * d],
            full[:, 3 * d].to(alpha_c.dtype))


def chees_adapt(target, state: HMCState, key: StepKey, n_adapt: int,
                eps0: float, traj_len0: float | None = None,
                target_accept: float = 0.651, adam_lr: float = 0.025,
                max_leapfrog: int = 1024):
    """Adapt the step size (dual averaging toward ``target_accept``) and
    the trajectory length (Adam ascent on the ChEES criterion, ``adam_lr``
    on ``log T``) together over ``n_adapt`` jittered steps
    (``chees.py:154-258``). Step ``m`` integrates for ``halton_u(m) T``,
    ``T`` clamped to ``[eps, max_leapfrog eps]`` at the current ``eps``;
    ``traj_len0`` defaults to ``eps0`` (one leapfrog). The recurrence runs
    in float32 on the host and reads one pair from the device a step.

    Returns ``(state, eps, traj_len, trace)``: the state after the leg,
    the ``m^-kappa``-averaged step size and trajectory length as host
    floats (``traj_len`` clamped to ``[eps, max_leapfrog eps]``), and the
    trace ``{"alpha", "traj_len", "eps"}``, each ``[n_adapt]`` float32 on
    the host: the cross-chain mean acceptance, ``exp(log T)`` after the
    Adam step and ``exp(log eps)`` after the dual-averaging step.
    """
    if n_adapt < 1:
        raise ValueError(f"n_adapt must be >= 1, got {n_adapt}")
    if traj_len0 is None:
        traj_len0 = eps0
    one = _f32(1.0)
    beta1, beta2, adam_eps = _f32(0.9), _f32(0.999), _f32(1e-8)
    mu = torch.log(_f32(10.0 * eps0))
    log_eps = torch.log(_f32(eps0))
    log_eps_bar = h_bar = adam_m = adam_v = _f32(0.0)
    log_T = log_T_bar = torch.log(_f32(traj_len0))
    log_max = torch.log(_f32(max_leapfrog))
    trace = torch.empty((3, n_adapt), dtype=torch.float32)
    for m in range(1, n_adapt + 1):
        m_f = _f32(m)
        eps = torch.exp(log_eps)
        log_T = torch.minimum(torch.maximum(log_T, log_eps),
                              log_eps + log_max)
        traj_len = torch.exp(log_T)
        u = halton_u(m)
        t = u * traj_len
        mom0, u_acc = step_draws(state.positions, key.generator, key.chains,
                                 key.state)
        new_state, pos_prop, mom_prop, alpha_c = jittered_step(
            target, state, float(eps),
            n_leapfrog(u, traj_len, eps, max_leapfrog), mom0, u_acc,
            key.state)
        # the cross-chain centring and means over every shard's chains
        # (one all-gather a step under a chain mesh)
        pos_all, prop_all, mom_all, alpha_all = _all_chains(
            key.chains, state.positions, pos_prop, mom_prop, alpha_c)
        g_dev = chees_grad_logT(pos_all, prop_all, mom_all, alpha_all,
                                float(t), key.state)
        # the leg's one device read a step
        alpha, g = torch.stack([alpha_all.mean(), g_dev]).to(
            torch.float32).cpu()
        state = new_state

        adam_m = beta1 * adam_m + (one - beta1) * g
        adam_v = beta2 * adam_v + (one - beta2) * g * g
        m_hat = adam_m / (one - beta1**m_f)
        v_hat = adam_v / (one - beta2**m_f)
        log_T = log_T + adam_lr * m_hat / (torch.sqrt(v_hat) + adam_eps)

        frac = one / (m_f + T_0)
        h_bar = (one - frac) * h_bar + frac * (target_accept - alpha)
        log_eps = mu - torch.sqrt(m_f) / GAMMA * h_bar
        w = m_f ** (-KAPPA)
        log_eps_bar = w * log_eps + (one - w) * log_eps_bar
        log_T_bar = w * log_T + (one - w) * log_T_bar
        trace[:, m - 1] = torch.stack([alpha, torch.exp(log_T),
                                       torch.exp(log_eps)])
    eps = torch.exp(log_eps_bar)
    traj_len = torch.minimum(torch.maximum(torch.exp(log_T_bar), eps),
                             eps * max_leapfrog)
    return state, float(eps), float(traj_len), dict(
        zip(("alpha", "traj_len", "eps"), trace))


def production_u(seed: int, step: int) -> float:
    """The production kernel's jitter ``u`` of global step ``step``: word
    x of Philox (chain 0, ``step``, ``CHEES_U_DRAW``, 0) under the run's
    key, as the float32 in (0, 1) the kernels' ``unit_open`` gives,
    computed on the host."""
    w0 = rng.philox_words(0, step & _MASK, CHEES_U_DRAW, 0, seed)[0]
    return float(rng.unit_open(torch.tensor(w0)))


def chees_hmc_kernel(target, step_size: float, traj_len: float,
                     max_leapfrog: int = 1024):
    """Build ``(init_fn, step_fn)`` for jittered-trajectory HMC, the
    production kernel ChEES adaptation tunes (``chees.py:261-302``).

    Each step integrates for ``u traj_len``, ``u ~ U(0, 1)`` from
    :func:`production_u` (iid, where the warm-up uses Halton), with ``L =
    clip(ceil(u traj_len / step_size), 1, max_leapfrog)`` leapfrogs, the
    mean ``~traj_len / (2 step_size)``. ``L`` is known on the host, so a
    step launches its kernels without waiting for the device. State and
    contract are ``ops/hmc.py``'s (``HMCState``, one gradient a leapfrog);
    ``init_fn(positions, state=None)`` takes the ``StateGroup`` of a
    rank's D-slice.
    """
    if step_size <= 0.0:
        raise ValueError(f"step_size must be > 0, got {step_size}")
    if traj_len <= 0.0:
        raise ValueError(f"traj_len must be > 0, got {traj_len}")
    eps = float(_f32(step_size))

    def init_fn(positions: torch.Tensor, state=None) -> HMCState:
        tgt = SliceTarget(target, state) if split(state) else target
        logp, grad = tgt.batch_logp_and_grad(positions)
        return HMCState(positions, logp, grad)

    def step_fn(state: HMCState, key: StepKey) -> HMCState:
        u = production_u(key.seed, key.step)
        mom0, u_acc = step_draws(state.positions, key.generator, key.chains,
                                 key.state)
        state, _, _, _ = jittered_step(
            target, state, eps, n_leapfrog(u, traj_len, eps, max_leapfrog),
            mom0, u_acc, key.state)
        return state

    return init_fn, step_fn
