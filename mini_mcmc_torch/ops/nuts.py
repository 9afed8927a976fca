"""No-U-Turn Sampler step kernel (iterative, lockstep-batched).

Counterpart of ``mini_mcmc_tpu/ops/nuts.py``: the reference's recursive
NUTS (``nuts.rs:550-996``, Hoffman & Gelman Algorithm 6 with slice sampling
and dual averaging) as an iterative binary-counter tree builder over
``[C, D]`` tensors (``kernels/nuts_subtree.py:build_subtree_plain``), with
the reference's constants and quirks: gamma 0.05, t0 10, kappa 0.75, the
divergence threshold 1000, the ``&&`` of ``find_reasonable_epsilon``'s
finiteness loop, the NaN-alpha guard and the saturating leapfrog counter.

Tiers (``use_pallas``):

- ``False``: the plain builder, every draw from the step's own
  ``torch.Generator`` (:func:`step_generator`);
- ``True``: each subtree in Kernel 3 (``kernels/nuts_subtree.py``), its
  merge uniforms from the TPU kernel's counter hash seeded by Philox words
  of (run key, step, j); the other draws from the generator;
- ``"full"``: the whole step in Kernel 4 (``kernels/nuts_full.py``), every
  draw from Philox at (run key, chain, step, draw).

``find_reasonable_epsilon_batch`` and ``_finish_step`` (dual averaging) stay
plain PyTorch on every tier, as the JAX package leaves them to XLA. The
step count ``m`` and the adaptation horizon ``n_discard`` are the same for
every chain, so the state keeps them as host integers: the warm-up depth
cap and the adaptation switch then need no device read.

Under a chain mesh (``key.chains``) the generator tiers draw the global
shapes and keep the shard's chains, Kernels 3 and 4 take the shard's first
global chain, the lockstep doubling and leaf loops run while a chain of
any shard runs, and the executed-leapfrog count is the deepest chain's
over every shard.
The step-size search stays local: it draws nothing inside its loop, so a
shard with no sentinel chain skipping it changes no draw.

Under a state split (``key.state``: D split over a ``"state"`` axis) the
lockstep tier draws the global ``[C, D]`` momenta's block and runs the
target on a DTensor view of its D-slice (``parallel.mesh.SliceTarget``),
taking the rank's share of each logp. Every sum over D of a step crosses
the axis in one all-reduce where it is taken: the step's start (its logp
and kinetic energy), each leaf (logp, kinetic energy and the U-turn dot
products of the merges after it, ``kernels/nuts_subtree.py``) and each
doubling (the U-turn between the trajectory's ends). Every state shard of
a chain then holds the same energies and takes the same decisions, and
the step-size search's loops stop together on every shard.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parallel.collectives import (
    chain_draw,
    max_chains,
    split,
    state_draw,
    state_sum,
)
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, chain0
from .kernels import rng
from .kernels.nuts_full import doubling_loop, nuts_step
from .kernels.nuts_subtree import build_subtree_plain, popcount, subtree

# Dual-averaging constants (nuts.rs:425-430)
GAMMA = 0.05
T_0 = 10.0
KAPPA = 0.75
#: safety cap for find_reasonable_epsilon loops (reference is uncapped)
_FIND_EPS_MAX_ITERS = 100
#: saturation ceiling of the int32 cumulative leapfrog counter, with 2^27
#: headroom so one more increment cannot wrap negative
_LEAPFROG_SAT = 2**31 - 2**27
#: Philox draw index of doubling j's subtree hash seed (chain 0) in the
#: use_pallas=True tier
SUBTREE_SEED_DRAW = 0x20000
#: Philox draw index (chain 0) of the seed of a step's torch.Generator in
#: the use_pallas=False and True tiers
STEP_GENERATOR_DRAW = 0x30000


class NUTSState(NamedTuple):
    """Batched NUTS chain state."""

    positions: torch.Tensor  # [C, D]
    epsilon: torch.Tensor  # [C] current step size (-1.0 sentinel = auto)
    epsilon_bar: torch.Tensor  # [C] averaged step size
    h_bar: torch.Tensor  # [C] dual-averaging error statistic
    mu: torch.Tensor  # [C] ln(10 * epsilon_0)
    m: int  # cumulative step count, the same for every chain
    n_discard: int  # adaptation horizon of the current run
    divergences: torch.Tensor  # [C] int32 count of divergent transitions
    #: [C] int32 cumulative leapfrogs: 2^J - 1 per step for a J-deep
    #: doubling loop, J the deepest chain's on the lockstep tiers (the
    #: executed cost) and each chain's own under use_pallas="full" (its own
    #: tree's cost); saturates at _LEAPFROG_SAT
    leapfrogs: torch.Tensor

    #: the state-dimension axis per field for ``parallel.
    #: shard_sampler_state(..., shard_state_dim=True)``: the [C] dual
    #: averaging and counters stay whole
    STATE_AXIS_INDEX = {"positions": 1}


def _leapfrog_batch(target, pos, mom, grad, eps):
    """Batched leapfrog: pos/mom/grad ``[C, D]``, eps ``[C]``."""
    e = eps[:, None]
    mom = mom + grad * (e * 0.5)
    pos = pos + mom * e
    logp, grad = target.batch_logp_and_grad(pos)
    mom = mom + grad * (e * 0.5)
    return pos, mom, grad, logp


def _all_real(x) -> bool:
    return bool(torch.isfinite(x).all())


def find_reasonable_epsilon(target, position, mom):
    """Step-size heuristic (nuts.rs:694-761) for one chain ``[D]``.

    Halve a trial multiplier while the first leapfrog is non-finite, set
    ``eps = 0.5 * k``, then double (or halve) until the acceptance
    probability crosses 1/2. The reference's quirks stay: the halving loop
    continues only while logp AND grad are non-real (nuts.rs:717), and the
    search starts at 0.5 even when that loop never runs.
    """
    one = torch.ones((1,), dtype=position.dtype, device=position.device)
    logp0, grad0 = target.batch_logp_and_grad(position[None])
    ke0 = 0.5 * torch.sum(mom * mom)

    def lf(eps):
        _, mom_p, grad_p, logp_p = _leapfrog_batch(
            target, position[None], mom[None], grad0, eps)
        return mom_p[0], grad_p[0], logp_p[0]

    k = one
    mom_p, grad_p, logp_p = lf(k)
    it = 0
    while (not _all_real(logp_p) and not _all_real(grad_p)
           and it < _FIND_EPS_MAX_ITERS):
        k = k * 0.5
        mom_p, grad_p, logp_p = lf(k)
        it += 1
    epsilon = 0.5 * k
    log_accept = logp_p - logp0[0] - (0.5 * torch.sum(mom_p * mom_p) - ke0)
    ln2 = math.log(2.0)
    a = 1.0 if bool(log_accept > -ln2) else -1.0
    it = 0
    while bool(a * log_accept > -a * ln2) and it < _FIND_EPS_MAX_ITERS:
        epsilon = epsilon * 2.0**a
        mom_p, _, logp_p = lf(epsilon)
        log_accept = logp_p - logp0[0] - (0.5 * torch.sum(mom_p * mom_p)
                                          - ke0)
        it += 1
    return epsilon[0]


def summed(state, *shares):
    """``[C]`` shares of sums over D, summed over the state axis in one
    all-reduce (``collectives.state_sum``); the shares themselves unless
    ``state`` splits D."""
    if not split(state):
        return shares
    return tuple(state_sum(torch.stack(shares), state).unbind(0))


def logp_and_grad(target, pos, state=None):
    """``target``'s logp and gradient at ``pos``; on a rank's D-slice
    (``state`` split) the rank's share of the logp, for :func:`summed`,
    and the gradient's slice."""
    if split(state):
        return SliceTarget(target, state).batch_logp_and_grad_share(pos)
    return target.batch_logp_and_grad(pos)


def find_reasonable_epsilon_batch(target, positions, mom, state=None):
    """:func:`find_reasonable_epsilon` for ``[C, D]`` chains at once -> ``[C]``.

    One masked loop over batched tensors: each iteration is one ``[C, D]``
    leapfrog, and a chain freezes once its own exit condition holds, so
    per-chain iteration counts (and the safety cap) match the scalar loop.
    On a rank's D-slice (``state`` split) each leapfrog's logp, kinetic
    energy and count of non-finite gradient coordinates cross the axis in
    one all-reduce, so every shard of a chain iterates alike.
    """
    c = positions.shape[0]
    one = torch.ones((c,), dtype=positions.dtype, device=positions.device)
    ln2 = math.log(2.0)
    logp0, grad0 = logp_and_grad(target, positions, state)
    logp0, ke0 = summed(state, logp0, torch.sum(mom * mom, dim=-1))
    ke0 = 0.5 * ke0

    def lf(eps):
        """``(kinetic sum, whether every gradient coordinate is finite,
        logp)`` after one leapfrog at ``eps``."""
        e = eps[:, None]
        mom_p = mom + grad0 * (e * 0.5)
        logp_p, grad_p = logp_and_grad(target, positions + mom_p * e, state)
        mom_p = mom_p + grad_p * (e * 0.5)
        ke_p = torch.sum(mom_p * mom_p, dim=-1)
        if not split(state):
            return ke_p, torch.isfinite(grad_p).all(dim=-1), logp_p
        n_bad = (~torch.isfinite(grad_p)).sum(dim=-1).to(ke_p.dtype)
        logp_p, ke_p, n_bad = summed(state, logp_p, ke_p, n_bad)
        return ke_p, n_bad == 0, logp_p

    def bad(logp_p, fin_p):
        # nuts.rs:717 quirk: continue only while logp AND grad are non-real
        return ~torch.isfinite(logp_p) & ~fin_p

    k = one
    ke_p, fin_p, logp_p = lf(k)
    it = 0
    while bool(bad(logp_p, fin_p).any()) and it < _FIND_EPS_MAX_ITERS:
        active = bad(logp_p, fin_p)
        k = torch.where(active, k * 0.5, k)
        ke_n, fin_n, logp_n = lf(k)
        ke_p = torch.where(active, ke_n, ke_p)
        fin_p = torch.where(active, fin_n, fin_p)
        logp_p = torch.where(active, logp_n, logp_p)
        it += 1

    epsilon = 0.5 * k
    log_accept = logp_p - logp0 - (0.5 * ke_p - ke0)
    a = torch.where(log_accept > -ln2, one, -one)
    two_pow_a = torch.pow(2.0, a)
    it = 0
    while (bool((a * log_accept > -a * ln2).any())
           and it < _FIND_EPS_MAX_ITERS):
        active = a * log_accept > -a * ln2
        epsilon = torch.where(active, epsilon * two_pow_a, epsilon)
        ke_p, _, logp_p = lf(epsilon)
        la = logp_p - logp0 - (0.5 * ke_p - ke0)
        log_accept = torch.where(active, la, log_accept)
        it += 1
    return epsilon


def _build_subtree(target, max_depth, pos, mom, grad, logu, v, j, epsilon,
                   joint_0, generator=None):
    """Single-chain subtree (a C = 1 view of the batched builder, merge
    uniforms from ``generator``); the golden tests' entry
    (``mini_mcmc_tpu/ops/nuts.py:_build_subtree``)."""

    def t(x):
        return torch.as_tensor(x, dtype=pos.dtype).reshape(1)

    res = build_subtree_plain(
        target, max_depth, pos[None], mom[None], grad[None], t(logu),
        torch.tensor([int(v)], dtype=torch.int32), int(j), t(epsilon),
        t(joint_0), torch.ones((1,), dtype=torch.bool),
        lambda i, k: torch.rand((1,), generator=generator, dtype=pos.dtype))
    return type(res)(*[x[0] for x in res])


def _depth_limit(m: int, n_discard: int, max_depth: int,
                 warmup_max_depth: Optional[int]) -> int:
    """The step's tree-depth cap: ``warmup_max_depth`` while adapting
    (``m <= n_discard``), ``max_depth`` after. Lockstep execution waits
    for the deepest tree, and during warm-up a few unequilibrated chains
    would otherwise force max-depth trees every step."""
    if (warmup_max_depth is not None and warmup_max_depth < max_depth
            and m <= n_discard):
        return warmup_max_depth
    return max_depth


def subtree_seed(seed: int, step: int, j: int) -> tuple[int, int]:
    """The two int32 hash-seed words of doubling ``j`` of global step
    ``step`` (Kernel 3): Philox words x, y at chain 0, draw
    ``SUBTREE_SEED_DRAW + j`` under the run's key."""
    w = rng.philox_words(0, step & 0xFFFFFFFF, SUBTREE_SEED_DRAW + j, 0,
                         seed)[:2]
    return tuple(x - (1 << 32) if x >> 31 else x for x in w)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The ``torch.Generator`` of one step of the ``use_pallas=False`` and
    ``True`` tiers, seeded by Philox words at (chain 0, ``step``,
    ``STEP_GENERATOR_DRAW``) under the run's key: a step's draws depend on
    (key, step) alone, not on how many draws earlier steps made."""
    w0, w1 = rng.philox_words(0, step & 0xFFFFFFFF, STEP_GENERATOR_DRAW, 0,
                              seed)[:2]
    return torch.Generator(device=device).manual_seed(w0 | (w1 << 32))


def _finish_step(state: NUTSState, target_accept_p: float, m: int,
                 position_sel, alpha, n_alpha, diverged,
                 leapfrog_inc) -> NUTSState:
    """Dual averaging and state assembly (nuts.rs:676-691), shared by
    every tier. ``leapfrog_inc`` is this step's executed-leapfrog count (an
    int, or ``[C]`` per chain from Kernel 4); the counter saturates at
    ``_LEAPFROG_SAT`` instead of wrapping."""
    dtype = position_sel.dtype
    mf = float(m)
    eta = 1.0 / (mf + T_0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (
        target_accept_p - alpha / torch.clamp(n_alpha, min=1).to(dtype))
    if m <= state.n_discard:
        epsilon = torch.exp(state.mu - math.sqrt(mf) / GAMMA * h_bar)
        eta2 = mf ** -KAPPA
        epsilon_bar = torch.exp((1.0 - eta2) * torch.log(state.epsilon_bar)
                                + eta2 * torch.log(epsilon))
    else:
        epsilon = epsilon_bar = state.epsilon_bar

    lf = state.leapfrogs.to(torch.int64)
    bumped = torch.clamp(lf + leapfrog_inc, max=_LEAPFROG_SAT)
    leapfrogs = torch.where(lf >= 0, bumped, lf).to(torch.int32)
    return NUTSState(
        positions=position_sel,
        epsilon=epsilon,
        epsilon_bar=epsilon_bar,
        h_bar=h_bar,
        mu=state.mu,
        m=m,
        n_discard=state.n_discard,
        divergences=state.divergences + diverged.to(torch.int32),
        leapfrogs=leapfrogs,
    )


def nuts_kernel(target, target_accept_p: float, max_depth: int = 10,
                use_pallas=False, warmup_max_depth: Optional[int] = None):
    """Build ``(init_fn, prepare_fn, step_fn)`` for batched NUTS.

    ``init_fn(positions [C, D], state=None) -> NUTSState`` (epsilon
    sentinel -1, nuts.rs:415-433; ``state`` places a rank's D-slice and
    changes nothing here); ``prepare_fn(state, key, n_discard)`` runs
    ``find_reasonable_epsilon`` for sentinel chains and resets
    ``mu = ln(10 * eps)`` (nuts.rs:528-545); ``step_fn(state, key)``.
    """
    if use_pallas not in (False, True, "full"):
        raise ValueError(
            f"use_pallas must be False, True or 'full'; got {use_pallas!r}")

    def init_fn(positions: torch.Tensor, state=None) -> NUTSState:
        c = positions.shape[0]
        kw = dict(dtype=positions.dtype, device=positions.device)
        ints = dict(dtype=torch.int32, device=positions.device)
        return NUTSState(
            positions=positions,
            epsilon=torch.full((c,), -1.0, **kw),
            epsilon_bar=torch.ones((c,), **kw),
            h_bar=torch.zeros((c,), **kw),
            mu=torch.full((c,), math.log(10.0), **kw),
            m=0,
            n_discard=0,
            divergences=torch.zeros((c,), **ints),
            leapfrogs=torch.zeros((c,), **ints),
        )

    def prepare_fn(state: NUTSState, key: StepKey,
                   n_discard: int) -> NUTSState:
        pos = state.positions
        mom_0 = state_draw(key.chains, key.state, lambda s: torch.randn(
            s, generator=key.generator, dtype=pos.dtype, device=pos.device),
            pos.shape)
        sentinel = (state.epsilon + 1.0).abs() <= torch.finfo(pos.dtype).eps
        epsilon = state.epsilon
        # the search runs only while some chain carries the sentinel (the
        # first run), like the reference's guard (nuts.rs:540-543)
        if bool(sentinel.any()):
            found = find_reasonable_epsilon_batch(target, pos, mom_0,
                                                  key.state)
            epsilon = torch.where(sentinel, found, epsilon)
        return state._replace(epsilon=epsilon,
                              mu=torch.log(10.0 * epsilon),
                              n_discard=n_discard)

    def full_step(state: NUTSState, key: StepKey) -> NUTSState:
        m = state.m + 1  # the reference increments at step start
        depth_limit = _depth_limit(m, state.n_discard, max_depth,
                                   warmup_max_depth)
        sel, alpha, n_alpha, diverged, depth = nuts_step(
            target, state.positions, state.epsilon, depth_limit, key.seed,
            key.step, max_depth, chain0(key))
        inc = torch.pow(2, depth.to(torch.int64)) - 1
        return _finish_step(state, target_accept_p, m, sel, alpha, n_alpha,
                            diverged > 0.5, inc)

    def step_fn(state: NUTSState, key: StepKey) -> NUTSState:
        positions = state.positions
        c = positions.shape[0]
        kw = dict(dtype=positions.dtype, device=positions.device)
        gen = step_generator(key.seed, key.step, positions.device)
        m = state.m + 1
        chains, st = key.chains, key.state

        def draw(fn, shape, axis=0):
            return chain_draw(chains, fn, shape, axis)

        mom_0 = state_draw(chains, st, lambda s: torch.randn(
            s, generator=gen, **kw), positions.shape)
        logp, grad = logp_and_grad(target, positions, st)
        logp, ke = summed(st, logp, torch.sum(mom_0 * mom_0, dim=1))
        joint = logp - 0.5 * ke
        logu = joint - draw(lambda s: torch.empty(s, **kw).exponential_(
            generator=gen), (c,))
        depth_limit = _depth_limit(m, state.n_discard, max_depth,
                                   warmup_max_depth)
        # the direction and progressive-accept uniforms of every doubling,
        # and each subtree's 2^j - 1 merge uniforms in one block drawn when
        # the doubling starts: how many draws precede any one is fixed, so
        # a chain's draws do not depend on how long other chains run
        def uniforms(shape):
            return draw(lambda s: torch.rand(s, generator=gen, **kw), shape,
                        1)

        directions = uniforms((max_depth, c))
        accepts = uniforms((max_depth, c))

        def tree(j, p, mo, g, v, active):
            if use_pallas:
                return subtree(target, p, mo, g, logu, v, j, state.epsilon,
                               joint, active,
                               subtree_seed(key.seed, key.step, j), max_depth,
                               chain0=chain0(key), chains=chains)
            merges = uniforms(((1 << j) - 1, c))
            return build_subtree_plain(
                target, max_depth, p, mo, g, logu, v, j, state.epsilon,
                joint, active,
                lambda i, k: merges[i - popcount(i) + k], chains=chains,
                state=st)

        sel, alpha, n_alpha, diverged, depth = doubling_loop(
            positions, mom_0, grad, joint, depth_limit,
            directions.__getitem__, accepts.__getitem__, tree, chains, st)
        # every chain pays the lockstep loop: 2^J - 1 leapfrogs, J the
        # deepest chain's over every shard
        n_doublings = max(max_chains(depth, chains), 0)
        return _finish_step(state, target_accept_p, m, sel, alpha, n_alpha,
                            diverged, (1 << n_doublings) - 1)

    return init_fn, prepare_fn, full_step if use_pallas == "full" else step_fn
