"""Batched coordinate-wise slice sampler (Neal 2003, stepping out and
shrinkage).

Counterpart of ``mini_mcmc_tpu/ops/slice.py``: one step is a sweep over
the coordinates, each a univariate slice update of every chain at once,
needing only ``target.logp``. The two data-dependent phases are masked
loops over the whole batch:

- stepping out widens each chain's bracket until both edges leave the
  slice or Neal's randomized budget (``J`` expansions left, ``m - 1 - J``
  right) is spent, both edges evaluated in one ``batch_logp`` call over
  ``[2 C, D]``;
- shrinkage draws a candidate for every unfinished chain, accepts inside
  the slice (``log y < logp``, strictly) and otherwise shrinks the bracket
  toward the current point, up to ``max_shrink`` iterations (a capped
  chain keeps its coordinate: an identity update).

Host tests: a loop ends when no chain is pending, and each such test reads
the device. A masked iteration past that point changes nothing, so
:func:`masked_loop` tests only every ``TEST_EVERY`` iterations; all of an
update's draws are made up front (``max_shrink`` shrink uniforms), so the
result does not depend on how often the host tests. No kernel: the JAX
package runs these loops in XLA. :func:`slice_update` takes its draws as
inputs, so a test can hand it the JAX package's own.

Under a chain mesh (``key.chains``) a shard draws the global shapes and
keeps its chains' draws, and a loop's test asks whether a chain of any
shard is pending (one scalar all-reduce a test), so every rank runs the
same iterations (``mini_mcmc_tpu``'s global ``any``).

Under a state split (``key.state``: D split over a ``"state"`` axis) the
sweep still walks the global coordinates ``0 .. D-1``, each with its
global width. The rank that holds coordinate ``i`` moves it; the others
keep their slice and evaluate the density with it unchanged. Every logp
runs on a DTensor view of the slice (``parallel.mesh.SliceTarget``),
summed over the axis: one all-reduce an evaluation. Every decision of an
update (an edge in the slice, a candidate accepted) reads only those
sums, the draws and the budgets, so every rank runs the same loop
iterations, and a rank that does not hold ``i`` never needs its value. A
sweep costs ``D x (1 + stepping-out iterations + shrink iterations)``
all-reduces of the state axis, plus one scalar all-reduce of the chain
axis a loop test; keep D small on a split.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..parallel.collectives import any_chains, chain_draw, split
from ..parallel.mesh import SliceTarget
from ..runner import StepKey, make_scan_block_fn


class SliceState(NamedTuple):
    positions: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C] cached target log density


class CoordinateDraws(NamedTuple):
    """One coordinate update's draws for ``C`` chains."""

    u_height: torch.Tensor  # [C] the slice height's uniform
    u_place: torch.Tensor  # [C] the bracket's placement around x
    left_budget: torch.Tensor  # [C] int64 in [0, max_stepouts)
    u_shrink: torch.Tensor  # [max_shrink, C] shrinkage iteration i's


def masked_loop(body: Callable, carry, pending: Callable, n_max: int,
                test_every: int, chains=None):
    """``carry = body(carry, i)`` for ``i = 0, 1, ...`` while
    ``pending(carry)`` (a 0-d bool device tensor) and ``i < n_max``, as a
    ``lax.while_loop`` would; ``pending`` is read on the host before every
    ``test_every``-th iteration only. Exact when a body with nothing
    pending returns its carry unchanged and nothing once done becomes
    pending again. Each read adds one to ``masked_loop.host_tests``. Under
    ``chains`` (a sharded run's ChainGroup) a test reads every shard's."""
    i = 0
    while i < n_max:
        if i % test_every == 0:
            masked_loop.host_tests += 1
            if not any_chains(pending(carry), chains):
                break
        carry = body(carry, i)
        i += 1
    return carry


masked_loop.host_tests = 0

#: loop iterations between the host's tests of "any chain pending": a
#: test is a device-to-host read, an iteration past the end a few dozen
#: launches that change nothing
TEST_EVERY = 2


def coordinate_draws(gen: torch.Generator, n_chains: int, max_stepouts: int,
                     max_shrink: int, like: torch.Tensor,
                     chains=None) -> CoordinateDraws:
    """A coordinate update's draws from ``gen``, on ``like``'s device (a
    shard's rows of the global draws under ``chains``)."""
    f = dict(generator=gen, dtype=like.dtype, device=like.device)

    def rand(shape, axis=0):
        return chain_draw(chains, lambda s: torch.rand(s, **f), shape, axis)

    return CoordinateDraws(
        rand((n_chains,)), rand((n_chains,)),
        chain_draw(chains, lambda s: torch.randint(
            0, max_stepouts, s, generator=gen, device=like.device),
            (n_chains,)),
        rand((max_shrink, n_chains), 1))


def slice_update(target, positions, logp, i: int, w: float,
                 draws: CoordinateDraws, max_stepouts: int,
                 test_every: int = TEST_EVERY, chains=None, d0: int = 0):
    """One slice update of coordinate ``i`` for every chain on given draws
    (``slice.py:105-190``), bracket width ``w`` (a float32 value). Returns
    the new ``(positions, logp)``, the same for any ``test_every``.
    ``d0``: the global index of the first column when ``positions`` holds
    a D-slice (``target`` then a ``SliceTarget``); a slice without
    coordinate ``i`` comes back unchanged, its bracket carried from 0."""
    c, d = positions.shape
    column = torch.arange(d0, d0 + d, device=positions.device) == i
    x = (positions[:, i - d0] if d0 <= i < d0 + d
         else positions.new_zeros((c,)))

    def f(values):
        """logp with coordinate i set to ``values`` ``[..., C]``: one
        ``batch_logp`` call however many leading rows."""
        p = torch.where(column, values[..., None], positions)
        return target.batch_logp(p.reshape(-1, d)).reshape(values.shape)

    logy = logp + torch.log(draws.u_height)
    left = x - w * draws.u_place
    right = left + w
    jb = draws.left_budget
    kb = (max_stepouts - 1) - jb
    fl, fr = f(torch.stack([left, right]))

    def grow(jb, kb, fl, fr):
        """Which edges still expand: budget left and the edge in the
        slice. The loop carries them, so a test reads them as they are."""
        return (jb > 0) & (logy < fl), (kb > 0) & (logy < fr)

    def out_body(carry, _):
        lv, rv, jb, kb, fl, fr, gl, gr = carry
        lv = torch.where(gl, lv - w, lv)
        rv = torch.where(gr, rv + w, rv)
        fl_new, fr_new = f(torch.stack([lv, rv]))
        jb, kb = jb - gl.to(jb.dtype), kb - gr.to(kb.dtype)
        fl, fr = torch.where(gl, fl_new, fl), torch.where(gr, fr_new, fr)
        return (lv, rv, jb, kb, fl, fr, *grow(jb, kb, fl, fr))

    # each chain grows for at most max_stepouts - 1 iterations in all
    left, right, *_ = masked_loop(
        out_body, (left, right, jb, kb, fl, fr, *grow(jb, kb, fl, fr)),
        lambda carry: (carry[6] | carry[7]).any(), max_stepouts - 1,
        test_every, chains)

    def shr_body(carry, it):
        lv, rv, x_new, lp_new, pending = carry
        cand = lv + draws.u_shrink[it] * (rv - lv)
        f_cand = f(cand)
        accept = pending & (logy < f_cand)
        x_new = torch.where(accept, cand, x_new)
        lp_new = torch.where(accept, f_cand, lp_new)
        pending = pending ^ accept  # accept implies pending
        # a rejected candidate becomes the edge on its side of x
        below = pending & (cand < x)
        lv = torch.where(below, cand, lv)
        rv = torch.where(pending ^ below, cand, rv)
        return lv, rv, x_new, lp_new, pending

    pending0 = torch.ones((c,), dtype=torch.bool, device=positions.device)
    _, _, x_new, lp_new, _ = masked_loop(
        shr_body, (left, right, x, logp, pending0),
        lambda carry: carry[4].any(), draws.u_shrink.shape[0], test_every,
        chains)
    return torch.where(column, x_new[:, None], positions), lp_new


def slice_kernel(target, *, width=1.0, max_stepouts: int = 8,
                 max_shrink: int = 32, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for the batched coordinate slice sweep.

    ``width``: the initial bracket width, a scalar or ``[D]`` (a host
    sequence or tensor); any positive width is exact, a poor one costs
    iterations. ``max_stepouts``: at most ``max_stepouts - 1`` expansions
    in all, split at random between the edges. ``max_shrink``: the cap on
    shrinkage iterations. ``steps_per_call`` > 1 attaches the K-sweep
    ``block_fn``. ``init_fn(positions, state=None)`` takes the
    ``StateGroup`` of a rank's D-slice; ``width`` is the global D's.
    """
    if max_stepouts < 1:
        raise ValueError(f"max_stepouts must be >= 1, got {max_stepouts}")
    if max_shrink < 1:
        raise ValueError(f"max_shrink must be >= 1, got {max_shrink}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    width = torch.as_tensor(width)
    if width.dim() > 1:
        raise ValueError(
            f"width must be a scalar or [D] array, got shape "
            f"{tuple(width.shape)}")
    if not bool((width > 0.0).all()):
        raise ValueError("width must be positive")
    width = width.cpu()

    def init_fn(positions: torch.Tensor, state=None) -> SliceState:
        tgt = SliceTarget(target, state) if split(state) else target
        return SliceState(positions, tgt.batch_logp(positions))

    def step_fn(state: SliceState, key: StepKey) -> SliceState:
        positions, logp = state
        c, d = positions.shape
        st, tgt, d0 = key.state, target, 0
        if split(st):  # the global coordinates, this rank's columns
            tgt, d, d0 = SliceTarget(target, st), st.n_dim, st.d0
        # float32 values on the host: the bracket's scalars
        widths = width.to(positions.dtype).expand(d).tolist()
        for i in range(d):
            draws = coordinate_draws(key.generator, c, max_stepouts,
                                     max_shrink, positions, key.chains)
            positions, logp = slice_update(tgt, positions, logp, i,
                                           widths[i], draws, max_stepouts,
                                           chains=key.chains, d0=d0)
        return SliceState(positions, logp)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
